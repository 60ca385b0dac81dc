"""The planar camera of the reference renderer: aiming on the host in
float64 (camera.c:132-341) and the primary rays of a mono frame
(ndt.c:456-576, camera_target_point camera.c:504-581)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.vec import (EPSILON, dot, np_angle, np_dist,
                                     np_l2norm, np_rotate, np_unitize, sqrt,
                                     unitize)

FOCAL_DISTANCE = 100.0     # the camera's default focal distance


def _aim_naive(view_point, target, rot):
    """camera_aim_naive from the reset camera (at the origin looking down
    +e2, screen 2 away, unit screen axes): rotate the defining points in
    every ordered (i, j) plane so that the view axis meets the target.
    Returns (pos, img_orig, dir_x, dir_y)."""
    d = len(view_point)
    e = np.eye(d)
    pos0 = np.zeros(d)
    img_orig = e[2] * 2.0
    dir_x, dir_y = e[0] * 1.0, e[1] * 1.0
    focal_len = float(np_dist(pos0, img_orig))
    x_len = float(np_l2norm(dir_x))
    y_len = float(np_l2norm(dir_y))
    img_orig = e[2] * focal_len
    dir_x, dir_y = e[0] * x_len, e[1] * y_len

    target_dist = float(np_dist(view_point, target))
    focal_len2 = float(np_l2norm(img_orig))
    img_orig = np_unitize(img_orig) * target_dist
    dir_x = dir_x * (target_dist / focal_len2)
    dir_y = dir_y * (target_dist / focal_len2)
    pos_x = img_orig + dir_x
    pos_y = img_orig + dir_y
    pos = pos0 + view_point
    pos_x = pos_x + view_point
    pos_y = pos_y + view_point
    img_orig = img_orig + view_point
    if rot != 0.0:
        pos_x, pos_y, img_orig = (np_rotate(p, pos, 0, 1, rot)
                                  for p in (pos_x, pos_y, img_orig))
    for i in range(d):
        for j in range(d):
            if i == j:
                continue
            vals = [img_orig[j] - pos[j], img_orig[i] - pos[i],
                    target[j] - pos[j], target[i] - pos[i]]
            cam_rise, cam_run, tar_rise, tar_run = (
                0.0 if abs(x) < EPSILON else x for x in vals)
            cam_angle = np.arctan2(cam_rise, cam_run)
            tar_angle = np.arctan2(tar_rise, tar_run)
            if tar_angle < cam_angle:
                tar_angle += 2.0 * np.pi
            ang = tar_angle - cam_angle
            pos_x = np_rotate(pos_x, pos, i, j, ang)
            pos_y = np_rotate(pos_y, pos, i, j, ang)
            img_orig = np_rotate(img_orig, pos, i, j, ang)
    return pos, img_orig, pos_x - img_orig, pos_y - img_orig


def aim(view_point, target, up):
    """camera_aim (camera.c:132-178): with an up vector, the roll that
    best lines up the screen's Y with it (a step search halved whenever
    it stops improving), then the naive aim."""
    view_point = np.asarray(view_point, np.float64)
    target = np.asarray(target, np.float64)
    up = np.zeros_like(view_point) if up is None else np.asarray(
        up, np.float64)
    curr = 0.0
    if float(np_l2norm(up)) > 0:
        ang = float(np_angle(up, _aim_naive(view_point, target, 0.0)[3]))
        delta = np.pi / 10.0
        while abs(delta) > (EPSILON / 1000.0):
            last = ang
            ang = float(np_angle(up, _aim_naive(view_point, target,
                                                curr)[3]))
            if ang >= last:
                delta = -delta / 2.0
            curr += delta
    return _aim_naive(view_point, target, curr)


def primary_rays(camera, width, height, dtype, device):
    """The rays of a mono frame's pixel centres, row-major: (o, v) [H W,
    D], v unit.  ``camera``: the scene's {"view_point", "view_target",
    "up"}."""
    pos, img_orig, dir_x, dir_y = aim(camera["view_point"],
                                      camera["view_target"],
                                      camera.get("up"))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    aspect = width / height
    if dtype == torch.float32:
        aspect = float(np.float32(aspect))
    npdt = {torch.float64: np.float64, torch.float32: np.float32}.get(
        dtype, np.float32)
    xs = np.arange(width, dtype=npdt) / width - 0.5
    ys = -(np.arange(height, dtype=npdt) / height - 0.5)
    xx, yy = np.meshgrid(xs, ys)
    x = torch.as_tensor(xx.ravel(), device=device).to(dtype)
    y = torch.as_tensor(yy.ravel(), device=device).to(dtype)
    pos_t, orig_t = t(pos), t(img_orig)
    dir_x_t = t(dir_x) * aspect
    pixel = t(dir_y) * y[:, None] + (dir_x_t * x[:, None] + orig_t)
    diff = orig_t - pos_t
    screen_dist = sqrt(dot(diff, diff))
    scaled = (pixel - pos_t) * (t(FOCAL_DISTANCE) / screen_dist) + pos_t
    pixel = torch.where(screen_dist > EPSILON, scaled, pixel)
    o = pos_t.expand(pixel.shape).contiguous()
    return o, unitize(pixel - o)
