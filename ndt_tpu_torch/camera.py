"""N-D camera: host aiming and the device screen-to-focal-surface map.

Counterpart of ``ndt_tpu/camera.py`` (camera.{h,c}).  Aiming runs on the
host in numpy float64 (per-frame scalar work); ``Camera.data`` packs the
result into ``CameraData``, a dataclass of tensors on the render device
that ``target_point`` and the engine's ray generator read.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import EPSILON, EYE_OFFSET
from ndt_tpu_torch.utils import telemetry


class CameraType(enum.IntEnum):
    """camera.h:16-19."""

    NORMAL = 0  # planar virtual screen
    VR = 1      # spherical screen
    PANO = 2    # cylindrical screen


@dataclasses.dataclass
class Camera:
    """Host camera state (camera.h:32-75).  Call :meth:`aim` after setting
    the view parameters to derive pos/dirX/dirY/imgOrig/eyes/locals."""

    dim: int
    type: CameraType = CameraType.NORMAL
    view_point: np.ndarray = None
    view_target: np.ndarray = None
    up: np.ndarray = None
    rotation: float = 0.0
    leveling: float = 0.0
    zoom: float = 1.0
    flip_x: bool = False
    flip_y: bool = False
    eye_offset: float = EYE_OFFSET
    h_fov: float = 2.0 * np.pi
    v_fov: float = np.pi / 2.0
    focal_distance: float = 100.0
    aperture_radius: float = 0.0

    # derived by aim()
    pos: np.ndarray = None
    img_orig: np.ndarray = None
    dir_x: np.ndarray = None
    dir_y: np.ndarray = None
    left_eye: np.ndarray = None
    right_eye: np.ndarray = None
    local_x: np.ndarray = None
    local_y: np.ndarray = None
    local_z: np.ndarray = None
    prepared: bool = False

    def __post_init__(self):
        d = self.dim
        if self.view_point is None:
            self.view_point = np.zeros(d)
        if self.view_target is None:
            self.view_target = np.zeros(d)
        if self.up is None:
            self.up = np.zeros(d)
        self._reset_derived()

    def _reset_derived(self, focal_len=2.0, x_len=1.0, y_len=1.0):
        """camera_init/camera_reset (camera.c:63-130): the default camera
        sits at the origin looking down +e2, screen ``focal_len`` away."""
        e = np.eye(self.dim, dtype=np.float64)
        self.pos = np.zeros(self.dim)
        self.dir_x = e[0] * x_len
        self.dir_y = e[1] * y_len
        self.img_orig = e[2] * focal_len
        self.left_eye = -self.eye_offset * e[0]
        self.right_eye = self.eye_offset * e[0]
        self.local_x = e[0].copy()
        self.local_y = e[1].copy()
        self.local_z = e[2].copy()
        self.prepared = False

    def set_aim(self, pos, target, up=None, rotation=0.0):
        """camera_set_aim (camera.c:329-341)."""
        self._reset_derived()
        self.view_point = np.asarray(pos, dtype=np.float64)
        self.view_target = np.asarray(target, dtype=np.float64)
        if up is not None:
            self.up = np.asarray(up, dtype=np.float64)
        self.rotation = float(rotation)
        self.leveling = 0.0
        return self

    def aim_naive(self):
        """camera_aim_naive (camera.c:180-327): reset to the default frame,
        then rotate the defining points in every ordered (i, j) plane so
        the view axis lines up with the target."""
        d = self.dim
        pos = self.view_point.copy()
        target = self.view_target.copy()
        rot = self.rotation + self.leveling

        # reset, keeping the previous focal length like camera_reset
        focal_len = float(mathnd.dist(self.pos, self.img_orig))
        x_len = float(mathnd.l2norm(self.dir_x))
        y_len = float(mathnd.l2norm(self.dir_y))
        self._reset_derived(focal_len, x_len, y_len)

        target_dist = float(mathnd.dist(pos, target))
        focal_len2 = float(mathnd.l2norm(self.img_orig))
        self.img_orig = mathnd.unitize(self.img_orig) * target_dist
        self.dir_x = self.dir_x * (target_dist / focal_len2)
        self.dir_y = self.dir_y * (target_dist / focal_len2)

        pos_x = self.img_orig + self.dir_x
        pos_y = self.img_orig + self.dir_y

        self.pos = self.pos + pos
        self.left_eye = self.left_eye + pos
        self.right_eye = self.right_eye + pos
        pos_x = pos_x + pos
        pos_y = pos_y + pos
        self.img_orig = self.img_orig + pos

        # roll in the screen plane before aiming (camera.c:249-254)
        pts = [pos_x, pos_y, self.img_orig, self.left_eye, self.right_eye]
        if rot != 0.0:
            pts = [mathnd.rotate(p, self.pos, 0, 1, rot) for p in pts]
        pos_x, pos_y, self.img_orig, self.left_eye, self.right_eye = pts

        # aim via atan2 in every ordered (i, j) plane (camera.c:257-289)
        for i in range(d):
            for j in range(d):
                if i == j:
                    continue
                cam_rise = self.img_orig[j] - self.pos[j]
                cam_run = self.img_orig[i] - self.pos[i]
                tar_rise = target[j] - self.pos[j]
                tar_run = target[i] - self.pos[i]
                if abs(cam_rise) < EPSILON:
                    cam_rise = 0.0
                if abs(cam_run) < EPSILON:
                    cam_run = 0.0
                if abs(tar_rise) < EPSILON:
                    tar_rise = 0.0
                if abs(tar_run) < EPSILON:
                    tar_run = 0.0
                cam_angle = np.arctan2(cam_rise, cam_run)
                tar_angle = np.arctan2(tar_rise, tar_run)
                if tar_angle < cam_angle:
                    tar_angle += 2.0 * np.pi
                ang = tar_angle - cam_angle
                pos_x = mathnd.rotate(pos_x, self.pos, i, j, ang)
                pos_y = mathnd.rotate(pos_y, self.pos, i, j, ang)
                self.img_orig = mathnd.rotate(self.img_orig, self.pos,
                                              i, j, ang)
                self.left_eye = mathnd.rotate(self.left_eye, self.pos,
                                              i, j, ang)
                self.right_eye = mathnd.rotate(self.right_eye, self.pos,
                                               i, j, ang)

        self.dir_x = pos_x - self.img_orig
        self.dir_y = pos_y - self.img_orig

        # local frame for VR/pano BEFORE flips/zoom (camera.c:303-309)
        self.local_x = mathnd.unitize(self.dir_x)
        self.local_y = mathnd.unitize(self.dir_y)
        self.local_z = mathnd.unitize(self.img_orig - self.pos)
        self.prepared = True

        if self.flip_x:
            self.dir_x = -self.dir_x
            self.left_eye, self.right_eye = self.right_eye, self.left_eye
        if self.flip_y:
            self.dir_y = -self.dir_y
        if self.zoom != 1.0 and abs(self.zoom) >= EPSILON:
            self.dir_x = self.dir_x / self.zoom
            self.dir_y = self.dir_y / self.zoom
        return self

    @telemetry.traced("ndt.camera.aim")
    def aim(self):
        """camera_aim (camera.c:132-178): with an 'up' vector, search the
        roll ('leveling') angle that best aligns up with the screen's Y,
        halving the step whenever it stops improving; then aim naively.
        The search's steps count under ``camera.aim_steps``."""
        if float(mathnd.l2norm(self.up)) > 0:
            tmp = Camera(self.dim)
            tmp.set_aim(self.view_point, self.view_target, self.up, 0.0)
            tmp.aim_naive()
            ang = float(mathnd.angle(self.up, tmp.dir_y))
            curr = 0.0
            delta = np.pi / 10.0
            steps = 0
            while abs(delta) > (EPSILON / 1000.0):
                steps += 1
                last = ang
                tmp.set_aim(self.view_point, self.view_target, self.up, curr)
                tmp.aim_naive()
                ang = float(mathnd.angle(self.up, tmp.dir_y))
                if ang >= last:
                    delta = -delta / 2.0
                curr += delta
            self.leveling = curr
            telemetry.count("camera.aim_steps", steps)
        return self.aim_naive()

    def focus(self, point):
        """camera_focus (camera.c:358-376): the focal distance is the
        camera-to-point vector's length along the view axis."""
        temp = np.asarray(point, dtype=np.float64) - self.pos
        self.focal_distance = float(mathnd.l2norm(mathnd.proj(temp,
                                                              self.local_z)))
        return self

    def focus_multi(self, points, near_padding=0.0, far_padding=0.0,
                    confusion_radius=0.1, img_plane_dist=-1.0):
        """camera_focus_multi (camera.c:378-479): binary-search the largest
        aperture that keeps every point within the circle of confusion
        (the thin-lens equation); sets aperture_radius and
        focal_distance."""
        pts = np.asarray(points, dtype=np.float64)
        dists = mathnd.dist(pts, self.view_point)
        min_dist = float(dists.min()) - near_padding
        max_dist = float(dists.max()) + far_padding
        min_radius, max_radius = 0.0, 1.0 / EPSILON
        if img_plane_dist < 0.0:
            img_plane_dist = float(mathnd.dist(self.pos, self.img_orig))
        while max_radius - min_radius > EPSILON**2:
            curr = (min_radius + max_radius) / 2.0
            conf_dist = (img_plane_dist * confusion_radius) / curr
            min_img = img_plane_dist - conf_dist
            max_img = img_plane_dist + conf_dist
            f = 2.0 / (1 / min_dist + 1 / min_img + 1 / max_dist
                       + 1 / max_img)
            u1 = 1.0 / (1 / f - 1 / min_img)
            u2 = 1.0 / (1 / f - 1 / max_img)
            if u2 < (min_dist - EPSILON) and u1 > (max_dist + EPSILON):
                min_radius = curr       # in focus: the aperture can grow
            else:
                max_radius = curr
            self.aperture_radius = curr
            self.focal_distance = 1.0 / (1 / f - 1 / img_plane_dist)
        return self

    def describe(self) -> str:
        """camera_print (camera.c:583-611)."""
        def v(x):
            return tuple(round(float(c), 4) for c in np.asarray(x))

        lines = [f"  camera type {int(self.type)}: viewPoint "
                 f"{v(self.view_point)} -> viewTarget {v(self.view_target)}"
                 f", up {v(self.up)}"]
        if self.type in (CameraType.VR, CameraType.PANO):
            lines.append(f"    vFov,hFov: {self.v_fov:g},{self.h_fov:g}")
        if self.rotation:
            lines.append(f"    rotation: {self.rotation:g}")
        if self.aperture_radius > 0:
            lines.append(f"    aperture radius: {self.aperture_radius:g}, "
                         f"focal distance: {self.focal_distance:g}")
        if self.prepared:
            lines.append(f"    pos {v(self.pos)}, imgOrig {v(self.img_orig)}")
            lines.append(f"    dirX {v(self.dir_x)}, dirY {v(self.dir_y)}")
        return "\n".join(lines)

    def print(self):
        print(self.describe())

    def data(self, dtype=torch.float32, device="cuda"):
        """Pack the derived state into tensors on ``device``, the card
        unless the caller asks for the CPU."""
        device = render_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=device)

        return CameraData(
            cam_type=int(self.type), pos=t(self.pos),
            img_orig=t(self.img_orig), dir_x=t(self.dir_x),
            dir_y=t(self.dir_y), left_eye=t(self.left_eye),
            right_eye=t(self.right_eye), local_x=t(self.local_x),
            local_y=t(self.local_y), local_z=t(self.local_z),
            h_fov=t(self.h_fov), v_fov=t(self.v_fov),
            # tan in f64 on the host: f32 rounds pi/2 up, which flips
            # tan's sign at vFov = pi (the C's tan(M_PI/2) is +1.6e16)
            tan_half_v=t(np.tan(float(self.v_fov) / 2.0)),
            focal_distance=t(self.focal_distance),
            aperture_radius=t(self.aperture_radius))


def render_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the CUDA device {device} was asked for and "
                           "torch.cuda.is_available() is false")
    return device


@dataclasses.dataclass(frozen=True)
class CameraData:
    """Device-side camera parameters: [D] vectors and 0-d scalars."""

    cam_type: int
    pos: torch.Tensor
    img_orig: torch.Tensor
    dir_x: torch.Tensor
    dir_y: torch.Tensor
    left_eye: torch.Tensor
    right_eye: torch.Tensor
    local_x: torch.Tensor
    local_y: torch.Tensor
    local_z: torch.Tensor
    h_fov: torch.Tensor
    v_fov: torch.Tensor
    tan_half_v: torch.Tensor
    focal_distance: torch.Tensor
    aperture_radius: torch.Tensor


def target_point(cam: CameraData, x, y, dist):
    """camera_target_point (camera.c:504-581): map normalized screen coords
    ``x, y`` ([R] tensors in [-0.5, 0.5]) to points on the focal surface:
    a sphere (VR), a cylinder (PANO) or the planar screen scaled onto the
    focal sphere (NORMAL).  The adds fuse the products, as XLA computes
    the JAX reference's f32."""
    if cam.cam_type in (int(CameraType.VR), int(CameraType.PANO)):
        azi = x * cam.h_fov
        if cam.cam_type == int(CameraType.VR):
            alt = y * cam.v_fov
            view_x = dist * torch.sin(azi) * torch.cos(alt)
            view_y = dist * torch.sin(alt)
            view_z = dist * torch.cos(azi) * torch.cos(alt)
        else:
            y_size = 2.0 * cam.tan_half_v * dist    # camera.c:540
            view_x = dist * torch.sin(azi)
            view_y = y * y_size
            view_z = dist * torch.cos(azi)
        pt = mathnd.fma(cam.local_x, view_x[..., None], cam.pos)
        pt = mathnd.fma(cam.local_y, view_y[..., None], pt)
        return mathnd.fma(cam.local_z, view_z[..., None], pt)
    pixel = mathnd.fma(cam.dir_y, y[..., None],
                       mathnd.fma(cam.dir_x, x[..., None], cam.img_orig))
    screen_dist = mathnd.dist(cam.img_orig, cam.pos)
    scaled = mathnd.fma(pixel - cam.pos, dist / screen_dist, cam.pos)
    return torch.where(screen_dist > EPSILON, scaled, pixel)
