"""Spinning textured shapes: the software-rendered analog of the
reference's OpenGL demo (myyuv_opengl/spinning_cube/).

A compute node has no display, so the demo renders frames with a pure-JAX
triangle rasterizer and writes them as BMPs. Feature parity with the
reference demo:

* ``shapes`` = N (1..1000) shapes placed by the same rejection sampling
  as ``generate_random_cube_pos`` (spinning_cube.cpp:288-312): uniform in
  a cube of radius sqrt(N), a candidate is rejected while any existing
  shape is within sqrt(3)*2, at most 1000 attempts; shape 0 sits at the
  origin (spinning_cube_yuv.cpp:74-76).
* each shape spins around +Y at ``cube_rotation_speed`` = 15 deg/s
  (spinning_cube.cpp:18, yuv.cpp:101-105).
* geometry: a +-1 cube under ``force_cube``, otherwise a parallelepiped
  with half-extents normalize(w, h, w) (create_parallelepiped,
  spinning_cube.cpp:157-160); ``flip_width_height`` swaps w/h first
  (spinning_cube_yuv.cpp:58-63 — a no-op for cubes).
* an airplane-style fly camera with the reference's exact state and
  update rules (Camera, spinning_cube.hpp:24-38, .cpp:46-74): yaw/pitch
  angles, speed 3, sensitivity 2.5, pitch clamped to +-89.9; the initial
  pose is pos=(r*2.5+3, 0, r*2.5+3), yaw=-135 looking at the field
  (spinning_cube_yuv.cpp:69-71). Headless stand-in for WASD/arrows: a
  scripted per-frame input sequence (``fly_script``) drives move/turn.
* projection/screen: perspective(45 deg, 1000/800, 0.1, 500) onto a
  1000x800 target, clear color (0.7, 0.75, 0.71)
  (spinning_cube.cpp:15-19, yuv.cpp:88).

Rasterization: a ``lax.scan`` over shapes; within a shape all 12
triangles test all pixels in parallel (edge-function barycentrics,
perspective-correct UV, 1/w z-buffer merged across scan steps) — batched
elementwise work instead of the GPU's per-fragment pipeline, so it jits
like everything else in the engine.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
_HI = jax.lax.Precision.HIGHEST

SHAPES_COUNT_MAX = 1000          # spinning_cube.cpp:15
SCREEN_WIDTH = 1000              # spinning_cube.cpp:16
SCREEN_HEIGHT = 800              # spinning_cube.cpp:17
CUBE_ROTATION_SPEED = 15.0       # deg/s, spinning_cube.cpp:18
CLEAR_BGR = (181, 191, 178)      # (0.7, 0.75, 0.71) RGB as BGR bytes
_NEAR, _FAR = 0.1, 500.0


def normalize_angle(angle: float) -> float:
    """Wrap to (-180, 180] (spinning_cube.cpp:79-85)."""
    if angle > 180.0:
        angle -= 360.0
    elif angle < -180.0:
        angle += 360.0
    return angle


def perspective(fovy_deg: float = 45.0,
                aspect: float = SCREEN_WIDTH / SCREEN_HEIGHT,
                near: float = _NEAR, far: float = _FAR) -> np.ndarray:
    """Row-major glm::perspective (spinning_cube.cpp:19)."""
    t = np.tan(np.radians(fovy_deg) / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1 / (aspect * t)
    m[1, 1] = 1 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def _sgn(v) -> float:
    return float(v > 0) - float(v < 0)


@dataclasses.dataclass
class Camera:
    """The reference fly camera (spinning_cube.hpp:24-38, .cpp:46-74)."""

    pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    pitch: float = 0.0
    yaw: float = -90.0
    speed: float = 3.0
    sensitivity: float = 2.5
    world_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 1, 0], np.float32))

    def __post_init__(self):
        self.update()

    def update(self) -> None:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = (np.cos(np.radians(self.pitch)),
                  np.sin(np.radians(self.pitch)))
        front = np.array([cy * cp, sp, sy * cp], np.float32)
        self.front = front / np.linalg.norm(front)
        right = np.cross(self.front, self.world_up)
        self.right = right / np.linalg.norm(right)
        up = np.cross(self.right, self.front)
        self.up = up / np.linalg.norm(up)

    def move(self, x: int, y: int, z: int, delta: float) -> None:
        vel = self.speed * delta
        self.pos = (self.pos + self.front * _sgn(x) * vel
                    + self.right * _sgn(z) * vel + self.up * _sgn(y) * vel)

    def turn(self, x: int, y: int, delta: float) -> None:
        self.yaw += _sgn(x) * self.sensitivity * delta * 10.0
        self.pitch = float(np.clip(
            self.pitch + _sgn(y) * self.sensitivity * delta * 10.0,
            -89.9, 89.9))
        self.yaw = normalize_angle(self.yaw)

    def view(self) -> np.ndarray:
        """Row-major glm::lookAt(pos, pos+front, up)."""
        f = self.front
        s = np.cross(f, self.up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4, dtype=np.float32)
        m[0, :3], m[1, :3], m[2, :3] = s, u, -f
        m[0, 3] = -np.dot(s, self.pos)
        m[1, 3] = -np.dot(u, self.pos)
        m[2, 3] = np.dot(f, self.pos)
        return m


def generation_radius(shapes_count: int) -> float:
    """spinning_cube.cpp:279-282 ("Because it works")."""
    return float(np.sqrt(shapes_count))


def generate_shape_positions(shapes_count: int,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """Rejection-sampled non-overlapping placement
    (generate_random_cube_pos, spinning_cube.cpp:288-312): shape 0 at the
    origin, candidates uniform in [-r, r]^3, rejected while any placed
    shape is within sqrt(3)*2; 1000 attempts per shape."""
    if not 1 <= shapes_count <= SHAPES_COUNT_MAX:
        raise ValueError(
            f"Shapes count must be between 1 and {SHAPES_COUNT_MAX}")
    rng = rng or np.random.default_rng(0)
    radius = generation_radius(shapes_count)
    two_radius = np.sqrt(3.0) * 2.0
    placed = [np.zeros(3, np.float32)]
    for _ in range(1, shapes_count):
        for attempt in range(1000):
            # generate_rand (spinning_cube.cpp:284-287) draws from
            # [min, max + 1): the +1 makes small fields placeable at all
            # (radius sqrt(2) < sqrt(3)*2), so mirror it exactly
            cand = rng.uniform(-radius, radius + 1.0, 3).astype(np.float32)
            d = np.linalg.norm(np.asarray(placed) - cand, axis=1)
            if (d > two_radius).all():
                placed.append(cand)
                break
        else:
            raise RuntimeError("Unable to generate new position")
    return np.asarray(placed, np.float32)


def shape_geometry(tex_w: int, tex_h: int, force_cube: bool = False,
                   flip_width_height: bool = False):
    """Vertices/triangles/UVs of the textured shape.

    ``force_cube``: the +-1 cube (create_cube, spinning_cube.cpp:86-155);
    otherwise half-extents normalize(w, h, w) (create_parallelepiped,
    spinning_cube.cpp:157-160). ``flip_width_height`` swaps w/h first
    (main.cpp:20-57; no-op for cubes)."""
    if force_cube:
        hx = hy = hz = 1.0
    else:
        w, h = (tex_h, tex_w) if flip_width_height else (tex_w, tex_h)
        c = np.array([w, h, w], np.float64)
        c = c / np.linalg.norm(c)
        hx, hy, hz = c
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32)
    faces = [
        (0, 1, 3, 2),  # -x
        (5, 4, 6, 7),  # +x
        (4, 0, 2, 6),  # -z
        (1, 5, 7, 3),  # +z
        (2, 3, 7, 6),  # +y (top)
        (4, 5, 1, 0),  # -y (bottom)
    ]
    uv = np.array([(0, 1), (1, 1), (1, 0), (0, 0)], np.float32)
    tris, uvs = [], []
    for q in faces:
        tris += [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
        uvs += [(uv[0], uv[1], uv[2]), (uv[0], uv[2], uv[3])]
    return (v, np.asarray(tris, np.int32), np.asarray(uvs, np.float32))


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def render_scene(texture_bgrx: jnp.ndarray, verts: jnp.ndarray,
                 tris: jnp.ndarray, uvs: jnp.ndarray,
                 positions: jnp.ndarray, angles_deg: jnp.ndarray,
                 view: jnp.ndarray, proj: jnp.ndarray,
                 out_h: int, out_w: int) -> jnp.ndarray:
    """Render N spinning shapes -> [out_h, out_w, 4] uint8 BGRX.

    Every float32 product runs at HIGHEST precision: on the GPU a default
    f32 matmul may run in TF32 (about three decimal digits), which would
    move rasterized edges between devices."""
    vp = jnp.matmul(proj, view, precision=_HI)             # [4, 4]
    ys = jnp.arange(out_h, dtype=F32)[:, None] + F32(0.5)
    xs = jnp.arange(out_w, dtype=F32)[None, :] + F32(0.5)

    def edge(x0, y0, x1, y1):
        return ((x1 - x0)[:, None, None] * (ys - y0[:, None, None])
                - (y1 - y0)[:, None, None] * (xs - x0[:, None, None]))

    uva, uvb, uvc = uvs[:, 0], uvs[:, 1], uvs[:, 2]

    def shape_step(carry, xp):
        best_iz, best_u, best_v = carry
        pos, ang = xp
        ra = jnp.radians(ang)
        ca, sa = jnp.cos(ra), jnp.sin(ra)
        rot_y = jnp.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], F32)
        world = jnp.matmul(verts, rot_y.T, precision=_HI) + pos[None, :]
        clip = jnp.matmul(jnp.concatenate(
            [world, jnp.ones((world.shape[0], 1), F32)], axis=1), vp.T,
            precision=_HI)
        wc = clip[:, 3]
        ok_v = wc > F32(_NEAR)                             # near-plane cull
        wsafe = jnp.where(ok_v, wc, 1.0)
        ndc = clip[:, :2] / wsafe[:, None]
        px = (ndc[:, 0] * F32(0.5) + F32(0.5)) * out_w
        py = (F32(0.5) - ndc[:, 1] * F32(0.5)) * out_h
        iz = jnp.where(ok_v, 1.0 / wsafe, 0.0)

        ax, ay = px[tris[:, 0]], py[tris[:, 0]]
        bx, by = px[tris[:, 1]], py[tris[:, 1]]
        cx, cy = px[tris[:, 2]], py[tris[:, 2]]
        za, zb, zc = iz[tris[:, 0]], iz[tris[:, 1]], iz[tris[:, 2]]
        tri_ok = (ok_v[tris[:, 0]] & ok_v[tris[:, 1]] & ok_v[tris[:, 2]])

        w0 = edge(bx, by, cx, cy)
        w1 = edge(cx, cy, ax, ay)
        w2 = edge(ax, ay, bx, by)
        area = w0 + w1 + w2
        # back-face cull + inside test (counter-clockwise winding => area
        # < 0 in this y-down pixel space)
        inside = ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)
                  & (area[..., :1, :1] < 0)
                  & tri_ok[:, None, None])
        safe_area = jnp.where(area == 0, 1.0, area)
        l0, l1, l2 = w0 / safe_area, w1 / safe_area, w2 / safe_area

        izp = (l0 * za[:, None, None] + l1 * zb[:, None, None]
               + l2 * zc[:, None, None])

        def interp(attr_a, attr_b, attr_c):
            return (l0 * (attr_a * za)[:, None, None]
                    + l1 * (attr_b * zb)[:, None, None]
                    + l2 * (attr_c * zc)[:, None, None]) \
                / jnp.where(izp == 0, 1.0, izp)

        uu = interp(uva[:, 0], uvb[:, 0], uvc[:, 0])
        vv = interp(uva[:, 1], uvb[:, 1], uvc[:, 1])

        key = jnp.where(inside, izp, -jnp.inf)
        best = jnp.argmax(key, axis=0)                     # [H, W]
        iz_here = jnp.max(key, axis=0)
        u_here = jnp.take_along_axis(uu, best[None], axis=0)[0]
        v_here = jnp.take_along_axis(vv, best[None], axis=0)[0]

        closer = iz_here > best_iz
        return ((jnp.where(closer, iz_here, best_iz),
                 jnp.where(closer, u_here, best_u),
                 jnp.where(closer, v_here, best_v)), None)

    init = (jnp.full((out_h, out_w), -jnp.inf, F32),
            jnp.zeros((out_h, out_w), F32),
            jnp.zeros((out_h, out_w), F32))
    (best_iz, best_u, best_v), _ = jax.lax.scan(
        shape_step, init, (positions.astype(F32), angles_deg.astype(F32)))

    hit = best_iz > -jnp.inf
    th, tw = texture_bgrx.shape[:2]
    ti = jnp.clip((best_v * th).astype(jnp.int32), 0, th - 1)
    tj = jnp.clip((best_u * tw).astype(jnp.int32), 0, tw - 1)
    texel = texture_bgrx[ti, tj]                           # [H, W, 4]
    bg = jnp.zeros((out_h, out_w, 4), jnp.uint8)
    bg = bg.at[..., 0].set(CLEAR_BGR[0]).at[..., 1].set(CLEAR_BGR[1])
    bg = bg.at[..., 2].set(CLEAR_BGR[2]).at[..., 3].set(255)
    return jnp.where(hit[..., None], texel, bg)


def default_fly_script(i: int) -> Tuple[int, int, int, int, int]:
    """Scripted stand-in for the interactive WASD/arrow input
    (handle_events, spinning_cube.cpp:233-275): fly forward while gently
    panning right — returns (x, y, z, view_x, view_y) for frame i."""
    return (1, 0, 0, 1 if i % 3 == 0 else 0, 0)


def render_spinning_cube(texture_bgrx: np.ndarray, out_dir,
                         n_frames: int = 24, out_size: int = 0,
                         shapes: int = 1, force_cube: bool = False,
                         flip_width_height: bool = False,
                         fly_script: Optional[Callable] = None,
                         frame_dt: float = 0.04,
                         seed: int = 0) -> list:
    """Render n_frames of the spinning-shapes demo to BMP files.

    ``out_size`` 0 uses the reference 1000x800 screen; otherwise a square
    out_size x out_size target. ``frame_dt`` is the per-frame time step
    (0.04 s = the reference's ~25 fps event loop)."""
    from . import export
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    th, tw = texture_bgrx.shape[:2]
    if out_size and out_size > 0:
        out_h = out_w = int(out_size)
    else:
        out_h, out_w = SCREEN_HEIGHT, SCREEN_WIDTH
    verts, tris, uvs = shape_geometry(tw, th, force_cube, flip_width_height)
    positions = generate_shape_positions(shapes, np.random.default_rng(seed))
    radius = generation_radius(shapes)

    cam = Camera()
    cam.pos = np.array([radius * 2.5 + 3.0, 0.0, radius * 2.5 + 3.0],
                       np.float32)
    cam.yaw = -135.0
    cam.update()
    proj = perspective(aspect=out_w / out_h)

    tex = jnp.asarray(texture_bgrx)
    vertsj, trisj, uvsj = (jnp.asarray(verts), jnp.asarray(tris),
                           jnp.asarray(uvs))
    posj = jnp.asarray(positions)
    angles = np.zeros(shapes, np.float32)
    paths = []
    for i in range(n_frames):
        if fly_script is not None:
            x, y, z, vx, vy = fly_script(i)
            cam.turn(vx, vy, frame_dt)
            cam.move(x, y, z, frame_dt)
            cam.update()
        frame = np.asarray(render_scene(
            tex, vertsj, trisj, uvsj, posj, jnp.asarray(angles),
            jnp.asarray(cam.view()), jnp.asarray(proj), out_h, out_w))
        p = out_dir / f"frame_{i:03d}.bmp"
        export.write_bgrx_bmp(p, frame)
        paths.append(p)
        angles = np.array([normalize_angle(a + CUBE_ROTATION_SPEED
                                           * frame_dt) for a in angles],
                          np.float32)
    return paths
