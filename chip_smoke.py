#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ndt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero with no "ok"
line):
  1. the card (nvidia-smi name and power limit), torch, nvcc;
  2. the nvcc build of the kernels;
  3. each CUDA kernel against its plain PyTorch twin on the card, at the
     main path's shapes: one 2^20-ray batch of 1080p balls primary rays,
     then the first bounce's rays; CUDA-event times of kernel and twin;
  4. render_frame of the 4-D balls scene, frame 0, 640x480 on the card:
     full frame against the C reference's golden PNG (RMSE < 1e-3), rows
     180:260 against the same rows rendered on the CPU through the twins;
  5. render_frame at 1920x1080 on the card, warmed, timed by the host clock
     around torch.cuda.synchronize(): s/frame, rays/frame, Mrays/s; the
     kernels' launch counters are reset right before this run and read
     right after it.
The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  JAX is never imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "balls_4d_640x480_f0.png")

# kernel-vs-twin bars (the f32 trace and frame bars of tests/test_render.py)
HIT_AGREE = 0.999        # fraction of live lanes with equal hit / miss
T_RTOL, T_ATOL = 2e-4, 2e-3
COLOR_TOL, COLOR_FRAC = 1e-3, 0.002   # |color diff| > tol on < frac lanes
NXT_AGREE = 0.999
CARRY_TOL = 1e-5         # o' v' w' frac' where both say nxt
GOLDEN_RMSE = 1e-3
PIXEL_TOL, PIXEL_FRAC = 1e-3, 0.002   # card vs CPU rows


def read_png_rgb(path):
    """[H, W, 3] uint8 of an 8-bit RGB / RGBA non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h = int.from_bytes(hdr[0:4], "big"), int.from_bytes(hdr[4:8], "big")
    depth, ctype, interlace = hdr[8], hdr[9], hdr[12]
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.int32)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros_like(line)
            for x in range(w * bpp):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:                       # 4: Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)[..., :3].astype(np.uint8)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def balls_scene():
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    mod = get_scene("balls")
    scn = Scene("balls", 4)
    mod.scene_setup(scn, 4, 0, 1500)
    mod.scene_cleanup()
    scn.cam.aim()
    return scn


def device_setup(scn, W, H, device):
    """Kernel tables and the aspect-corrected camera, as render_frame
    builds them."""
    import dataclasses

    import torch

    from ndt_tpu_torch.scene import compile_scene, to_device

    sd = to_device(compile_scene(scn), device)
    cam = scn.cam.data(dtype=torch.float32, device=device)
    cam = dataclasses.replace(
        cam, dir_x=cam.dir_x * float(np.float32(W / H)))
    return sd, cam


def cuda_ms(fn, reps, prefill=False):
    """Time per call on the stream: CUDA events around ``reps`` calls after
    two warm-up calls.  By default this includes any gap in which the
    device waits for the host to enqueue the next call.  ``prefill``, for a
    function that never synchronizes: a spin kernel holds the stream while
    the host enqueues all ``reps`` calls, so the events bracket device work
    only."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_trace(a, b, live):
    t_a, m_a, n_a, p_a = a
    t_b, m_b, n_b, p_b = b
    hit_a, hit_b = t_a < 5e29, t_b < 5e29
    n_live = live.sum().item()
    agree = ((hit_a == hit_b) & live).sum().item() / n_live if n_live else 1.0
    both = hit_a & hit_b & live
    err = (t_a - t_b).abs()[both]
    t_ok = bool((err <= T_ATOL + T_RTOL * t_b.abs()[both]).all())
    mat_ok = bool((m_a[both] == m_b[both]).all())
    max_err = err.max().item() if err.numel() else 0.0
    ok = agree >= HIT_AGREE and t_ok and mat_ok
    return ok, max_err, (f"hit agreement {agree:.6f}, t max |diff| "
                         f"{max_err:.3e}, t within bar {t_ok}, "
                         f"mat equal {mat_ok}")


def compare_shade(a, b, live):
    o_a, v_a, w_a, f_a, c_a, nx_a = a
    o_b, v_b, w_b, f_b, c_b, nx_b = b
    n_live = live.sum().item()
    cd = (c_a - c_b).abs().amax(1)[live]
    bad = (cd > COLOR_TOL).sum().item() / n_live if n_live else 0.0
    nxt_agree = (((nx_a == nx_b) & live).sum().item() / n_live
                 if n_live else 1.0)
    both = nx_a & nx_b & live
    carry = max(float((x - y).abs()[both].max()) if both.any() else 0.0
                for x, y in ((o_a, o_b), (v_a, v_b), (w_a, w_b),
                             (f_a[:, None], f_b[:, None])))
    max_err = cd.max().item() if cd.numel() else 0.0
    ok = bad < COLOR_FRAC and nxt_agree >= NXT_AGREE and carry <= CARRY_TOL
    return ok, max_err, (f"color max |diff| {max_err:.3e}, lanes > "
                         f"{COLOR_TOL}: {bad:.6f}, nxt agreement "
                         f"{nxt_agree:.6f}, carry max |diff| {carry:.3e}")


def phase_kernels(torch, K, results):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    from ndt_tpu_torch.render.engine import (_TILE, _blocked_perm,
                                             _pixel_grid, gen_rays)
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    W, H = 1920, 1080
    sd, cam = device_setup(balls_scene(), W, H, "cuda")
    xx, yy = _pixel_grid(W, H, np.float32)
    perm, _ = _blocked_perm(W, H)
    x = torch.as_tensor(xx.ravel()[perm][:_TILE], device="cuda")
    y = torch.as_tensor(yy.ravel()[perm][:_TILE], device="cuda")
    o, v = gen_rays(cam, x, y)
    R = o.shape[0]
    kinds, lvec = fused_light_info(sd)
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    live = torch.ones(R, dtype=torch.bool, device="cuda")
    w = torch.ones((R, 3), device="cuda")
    frac = torch.ones(R, device="cuda")
    color = torch.zeros((R, 3), device="cuda")
    ok_all = True
    for stage in ("primary", "first bounce"):
        lists, counts = K.cull_lists(sd, o, v, live=live)
        tr_args = (sd, o, v, aux, lists, counts)
        got = K.trace_closest(*tr_args)
        ref = K.trace_closest_ref(*tr_args)
        ok, err, msg = compare_trace(got, ref, live)
        print(f"[kernels] trace_closest {stage} R={R} live="
              f"{live.sum().item()}: {msg} -> {'PASS' if ok else 'FAIL'}")
        ok_all &= ok
        t, mat, nrm, props = got
        culls = _shadow_culls(sd, kinds, lvec, o, v, t, live)
        sh_args = (sd, o, v, t, mat, nrm, props, lvec, culls, kinds, True,
                   w, frac, color, live)
        sgot = K.shade_carry(*sh_args)
        sref = K.shade_carry_ref(*sh_args)
        sok, serr, smsg = compare_shade(sgot, sref, live)
        print(f"[kernels] shade_carry {stage}: {smsg} -> "
              f"{'PASS' if sok else 'FAIL'}")
        ok_all &= sok
        if stage == "primary":
            results["trace_closest"]["max_abs_err"] = err
            results["shade_carry"]["max_abs_err"] = serr
            for name, kern, twin, args in (
                    ("trace_closest", K.trace_closest, K.trace_closest_ref,
                     tr_args),
                    ("shade_carry", K.shade_carry, K.shade_carry_ref,
                     sh_args)):
                r = results[name]
                r["ms"] = cuda_ms(lambda: kern(*args), 20, prefill=True)
                r["plain_ms"] = cuda_ms(lambda: twin(*args), 5)
                on_stream = cuda_ms(lambda: kern(*args), 20)
                print(f"[kernels] {name} at {R} primary rays: kernel "
                      f"{r['ms']:.4f} ms device time (mean of 20, queue "
                      f"pre-filled), {on_stream:.4f} ms per call on the "
                      f"stream; twin {r['plain_ms']:.3f} ms per call "
                      "(CUDA events, mean of 5)")
            o, v, w, frac, color, live = sgot
            o, v = o.contiguous(), v.contiguous()
    return ok_all


def phase_golden(torch, K, card):
    """Phase 4: 640x480 on the card vs the C golden and vs the CPU twins."""
    from ndt_tpu_torch.image import linear_to_bytes
    from ndt_tpu_torch.render.engine import (RenderOptions, _pixel_grid,
                                             render_frame, render_tile)

    W, H = 640, 480
    opts = RenderOptions(width=W, height=H)
    K.reset_launch_counts()
    img, _, rays = render_frame(balls_scene(), opts, device="cuda")
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    ok = img.shape == (H, W, 3) and bool(np.isfinite(img).all())
    ref = read_png_rgb(GOLDEN).astype(np.float64) / 255.0
    mine = linear_to_bytes(img).astype(np.float64) / 255.0
    rmse = float(np.sqrt(((mine - ref) ** 2).mean()))
    ok &= rmse < GOLDEN_RMSE and all(n > 0 for n in counts.values())
    print(f"[golden] balls 4-D f0 {W}x{H} on {card}: RMSE {rmse:.3e} vs C "
          f"golden (bar {GOLDEN_RMSE}), rays {rays}, launches {counts}")

    rows = slice(180, 260)
    sd, cam = device_setup(balls_scene(), W, H, "cpu")
    xx, yy = _pixel_grid(W, H, np.float32)
    c, _, _ = render_tile(sd, cam, torch.as_tensor(xx[rows].ravel()),
                          torch.as_tensor(yy[rows].ravel()), opts)
    cpu = c.numpy().reshape(-1, W, 3)
    d = np.abs(img[rows] - cpu).max(-1)
    off = float((d > PIXEL_TOL).mean())
    band_ok = off < PIXEL_FRAC
    print(f"[golden] rows 180:260 card vs CPU twins: max |diff| "
          f"{d.max():.3e}, pixels > {PIXEL_TOL}: {off:.6f} (bar "
          f"{PIXEL_FRAC}) -> {'PASS' if band_ok else 'FAIL'}")
    return ok and band_ok


def phase_frame(torch, K, card, results):
    """Phase 5: the 1080p main path, timed."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    W, H = 1920, 1080
    opts = RenderOptions(width=W, height=H)
    scn = balls_scene()
    render_frame(scn, opts, device="cuda")              # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    img, _, rays = render_frame(scn, opts, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.launch_counts)
    for name, n in launches.items():
        results[name]["launches"] = n
    times = [dt]
    for _ in range(2):
        t0 = time.perf_counter()
        render_frame(scn, opts, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s = float(np.median(times))
    ok = (img.shape == (H, W, 3) and bool(np.isfinite(img).all())
          and all(r["launches"] > 0 for r in results.values()))
    print(f"[frame] balls 4-D f0 {W}x{H} on {card}: {s:.4f} s/frame "
          f"(median of {len(times)}: {', '.join(f'{x:.4f}' for x in times)}),"
          f" {rays} rays/frame, {rays / s / 1e6:.1f} Mrays/s; launches "
          f"{launches} in the first timed frame")
    return ok


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"[env] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{build.nvcc_version(build.find_nvcc())}")
    t0 = time.perf_counter()
    build.load_library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s")

    results = {
        "trace_closest": dict(
            name="trace_closest", route="cuda",
            source="ndt_tpu_torch/csrc/trace_closest.cu",
            replaces="ndt_tpu/render/pallas_trace.py:1730"),
        "shade_carry": dict(
            name="shade_carry", route="cuda",
            source="ndt_tpu_torch/csrc/shade_carry.cu",
            replaces="ndt_tpu/render/pallas_trace.py:1128"),
    }
    ok = phase_kernels(torch, K, results)
    ok &= phase_golden(torch, K, card)
    ok &= phase_frame(torch, K, card, results)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:                    # any phase error: report, fail
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
