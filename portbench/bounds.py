"""The least time of the program's kernel launches: the chip's peaks and
the bytes a launch must move, counted from the shapes of the arguments
its entry point was given.

A launch's bound is its bytes over the peak bandwidth: each input byte
read once and each output byte written once, for the lanes the launch
serves.  A launch given a live mask serves its live lanes (and reads the
mask); without one, every lane.  Counted per lane: the rays (o, v), the
aux word (excluded material or distance limit) or the shade inputs (t,
material, normal, properties, and in carry mode w, frac, colour), the
outputs (t, material, normal, properties; or the bounce's o, v, w, frac,
colour and flags; or the local colour); per launch the candidate lists
as listed (the counts' sum, and the reach keys with the early exit).
The scene's tables are left out (a few kB to a few MB, read through the
cache), so the bound is a lower bound and the share of it can only be
too low.  The pattern is ``chip_smoke.py``'s ``trace_bound``.
"""

from __future__ import annotations

# the card's peak memory bandwidth, bytes/s (NVIDIA's H100 SXM data sheet,
# at the 700 W limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
F32 = I32 = 4


def bandwidth(card):
    """The peak bandwidth of the card named as torch names it."""
    if card not in HBM_BYTES_PER_S:
        raise ValueError(f"no peak bandwidth for the card {card!r}")
    return HBM_BYTES_PER_S[card]


def _lists(call):
    """Bytes of the listed candidates of a launch's cull: 4 per listed
    gid, 4 more per reach key with the early exit."""
    return int(call["counts"].sum()) * I32 * (2 if call["reach"] else 1)


def launch_bytes(call):
    """The bytes one recorded launch must move.  ``call``: the recorder's
    dict (``kind``, ``R``, ``D``, ``live`` count or None, ``counts`` and
    its shade ``culls``' counts, ``reach``, ``escalate``, ``n_area``)."""
    R, D = call["R"], call["D"]
    lanes = R if call["live"] is None else call["live"]
    mask = 0 if call["live"] is None else R
    kind = call["kind"]
    if kind == "trace_closest":
        per = 2 * D * F32 + I32 + (F32 + I32 + D * F32 + 8 * F32)
        return lanes * per + mask + _lists(call)
    if kind in ("trace_any", "trace_shadow"):
        per = 2 * D * F32 + F32 + (F32 + I32)
        return lanes * per + mask + _lists(call)
    shade_in = (2 * D * F32 + F32 + I32 + D * F32 + 8 * F32
                + call.get("n_area", 0) * D * F32)
    culls = sum(int(c.sum()) * I32 for c in call["culls"])
    if kind == "shade_carry":
        per = (shade_in + 3 * F32 + F32 + 3 * F32
               + (2 * D * F32 + 3 * F32 + F32 + 3 * F32 + 1
                  + (1 if call.get("escalate") else 0)))
        return lanes * per + mask + culls
    if kind == "shade_local":
        return lanes * (shade_in + 3 * F32) + culls
    raise ValueError(f"no byte count for a {kind!r} launch")
