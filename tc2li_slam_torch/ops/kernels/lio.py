"""The LiDAR-inertial scan step of the IMU mode: four hand-written CUDA
kernels + their plain versions.

Replaces, in ``tc2li_slam_tpu``, what the TPU runs inside the one jit of
``slam/lio.py:99`` (``lio_scan_step``): ``estimation/esekf.py:192``
(``predict``, its ``lax.scan`` :257), ``slam/lio.py:46`` (``make_h_fn``)
with ``ops/voxel_map.py:154`` (``knn``) and ``ops/plane_fit.py:90``
(``fit_planes``), and ``estimation/esekf.py:266`` (``update_iterated``,
its ``lax.scan`` :308) with the divergence guard. Written as eager PyTorch
(``predict_plain``, ``make_h_fn``, ``scan_update_plain``) a scan step is
~5,000 small ops, each a launch, on every frame of the IMU mode.

Bound on the H100: latency (``csrc/lio.cu`` says how). A scan step at
``max_iters`` k is ``device_launches_per_scan(k)`` = 1 + (k + 2) + (k + 1)
launches on the current stream and no host sync; ``launches_per_scan(k)``
counts the kernels' runs, the fence table's in the predict launch:

- ``esekf_predict`` (``predict_launches``): two warps, the window in rounds
  of 32 slots: a sample's terms a lane a sample and the chain of R, p and v
  on nine lanes of one warp (a lane an entry of the 3 x 3 products);
  P <- F P F^T + Fw Q Fw^T from F's block structure on the other, a lane a
  column of P, each sample as soon as the chain has reached it; a sample
  with ``dt <= 0`` is skipped, an exact no-op at any launch size.
- ``lio_fences`` (``fence_launches``): the pool keys' fence table, every
  32nd key, once a scan step (``fences_plain``), written by blocks of their
  own in the predict launch (``predict_with_fences``): the table has no
  launch of its own.
- ``lio_rows`` (``rows_launches``): one evaluation of the measurement at an
  iterate's state in device memory: kNN of radius 2 in the voxel pool (a
  warp 4 points, a lane a voxel column, the key search through the fence
  table), then the 5-point plane fit, the gate and the row a lane a point;
  each block's float64 sums of h h^T (the 6, or 12 with the extrinsic,
  non-zero columns), h z and the inlier count over its batches of 32 points
  in a fixed order, entry-major [E, blocks]. The last evaluation, at the
  guarded state, writes p_w and counts the inliers.
- ``esekf_step`` (``step_launches``): a MAP step from the blocks' sums, or
  the final covariance (Gauss-Jordan on the block) with the guard, on one
  block in float64: the sums' reduction beside the tangent terms at the
  iterate (and, at the first launch, P0^-1 by Gauss-Jordan on four warps),
  the assembly, the Cholesky solve on one warp, boxplus.

The prediction and the neighbour search are float32, as the plain
versions; the plane fit, the gate, the rows' sums and the step are float64
from the float32 inputs. The kernels therefore agree with the plain
versions to rounding, not to the bit: a query within an ulp of a voxel face
may find another neighbour set, a near-collinear plane fit another normal,
and the update agrees with the plain version run in float64
(``esekf.map_step``, ``esekf.posterior_covariance``) more closely than the
float32 one does. The same bits on every call.

``estimation/esekf.predict`` and ``slam/lio.iterated_update`` send CUDA
tensors to the kernels and CPU tensors to the plain versions; any other
device raises. There is no other route. On the card ``slam/lio.
lio_scan_step`` predicts with ``predict_with_fences`` and hands the table
to the update.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...estimation import esekf
from ...geom import lie
from ...ops import plane_fit, voxel_map
from ...tensors import count
from . import build

predict_launches = 0   # kernel launches by esekf_predict (plain-version calls excluded)
fence_launches = 0     # fence tables written (by the fence blocks of a predict launch)
rows_launches = 0      # ... by lio_rows
step_launches = 0      # ... by esekf_step
STATE_FLOATS = 36      # pos, R, R_LI, t_LI, vel, bg, ba, grav
ERR_DIM = 23           # esekf.ERR_DIM
PACKED_FLOATS = STATE_FLOATS + ERR_DIM ** 2   # the state, then P
_SHAPES = (("pos", (3,)), ("R", (3, 3)), ("R_LI", (3, 3)), ("t_LI", (3,)), ("vel", (3,)),
           ("bg", (3,)), ("ba", (3,)), ("grav", (3,)))


def launches_per_scan(max_iters: int) -> dict:
    """The kernels' runs a scan step at ``max_iters``, by their counters:
    ``lio_fences``' run is the fence blocks of the predict launch."""
    return {"esekf_predict": 1, "lio_fences": 1, "lio_rows": max_iters + 2,
            "esekf_step": max_iters + 1}


def device_launches_per_scan(max_iters: int) -> int:
    """The launches a scan step makes on the device: predict (with the
    fence table), k + 2 evaluations, k + 1 steps."""
    return 1 + (max_iters + 2) + (max_iters + 1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def predict_plain(f: esekf.Filter, gyro, acc, dts, noise: esekf.NoiseCfg):
    """``esekf.predict``'s per-sample loop: propagate through an IMU window
    gyro [N, 3], acc [N, 3], dts [N] (<= 0 = padding). Returns (filter,
    body_R_traj [N, 3, 3], body_p_traj [N, 3])."""
    dtype, dev = gyro.dtype, gyro.device
    ERR_DIM, POS, ROT, VEL, BG, BA, GRAV = (esekf.ERR_DIM, esekf.POS, esekf.ROT, esekf.VEL,
                                            esekf.BG, esekf.BA, esekf.GRAV)
    x, P = f.x, f.P
    active = dts > 0
    dts = torch.where(active, dts, 0.0)
    # bg, ba and grav do not change inside predict: the per-sample rotation
    # increments, their Jacobians and the gravity tangent are batched
    phi = torch.where(active[:, None], gyro - x.bg, 0.0) * dts[:, None]
    dRi_all = lie.so3_exp(phi)
    Jr_all = lie.so3_right_jacobian(phi)
    a_ub_all = torch.where(active[:, None], acc - x.ba, 0.0)
    a_hat_all = lie.hat(a_ub_all)
    gB = -lie.hat(x.grav) @ esekf.s2_basis(x.grav)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eyeE = torch.eye(ERR_DIM, dtype=dtype, device=dev)
    q = torch.cat([torch.full((3,), v ** 2, dtype=dtype, device=dev)
                   for v in (noise.gyr, noise.acc, noise.bg_rw, noise.ba_rw)])

    pos, R, vel = x.pos, x.R, x.vel
    R_traj, p_traj = [], []
    for i in range(gyro.shape[0]):
        dt = dts[i]
        dRi, Jr = dRi_all[i], Jr_all[i]
        acc_w = R @ a_ub_all[i] + x.grav

        F = eyeE.clone()
        F[POS, VEL] = eye3 * dt
        F[ROT, ROT] = dRi.T
        F[ROT, BG] = -Jr * dt
        F[VEL, ROT] = -R @ a_hat_all[i] * dt
        F[VEL, BA] = -R * dt
        F[VEL, GRAV] = gB * dt
        Fw = torch.zeros((ERR_DIM, 12), dtype=dtype, device=dev)
        Fw[ROT, 0:3] = -Jr * dt
        Fw[VEL, 3:6] = -R * dt
        Fw[BG, 6:9] = eye3 * dt
        Fw[BA, 9:12] = eye3 * dt
        P = F @ P @ F.T + (Fw * q[None, :]) @ Fw.T

        pos = pos + vel * dt + 0.5 * acc_w * dt * dt
        vel = vel + acc_w * dt
        R = R @ dRi
        R_traj.append(R)
        p_traj.append(pos)

    x = x._replace(pos=pos, R=R, vel=vel)
    if not R_traj:
        return esekf.Filter(x, P), torch.zeros((0, 3, 3), dtype=dtype, device=dev), \
            torch.zeros((0, 3), dtype=dtype, device=dev)
    return esekf.Filter(x, P), torch.stack(R_traj), torch.stack(p_traj)


def make_h_fn(m: voxel_map.VoxelMap, points_l, valid, cfg, with_slots: bool = False):
    """The measurement closure of the iterated update (``h_share_model``).
    ``points_l`` [M, 3] are undistorted, downsampled points in the LiDAR
    frame at scan end; the closure re-evaluates kNN + plane fit at the state
    it is given and returns (z [M], H [M, 23], ok [M]), and with
    ``with_slots`` the pool slots of each point's valid neighbours [M, 5]
    (-1 elsewhere)."""
    norm_p = torch.linalg.norm(points_l, dim=-1)
    gate_den = torch.sqrt(torch.clamp(norm_p, min=1e-6))

    def h_fn(x: esekf.State):
        p_b = points_l @ x.R_LI.T + x.t_LI          # body frame
        p_w = p_b @ x.R.T + x.pos                   # world frame
        dists, nbrs, nb_valid, *slots = voxel_map.knn(m, p_w, k=5, radius=2,
                                                      with_slots=with_slots)
        normals, d, plane_ok = plane_fit.fit_planes(nbrs, nb_valid, cfg.plane_thresh)
        pd = plane_fit.point_to_plane(p_w, normals, d)
        # FAST-LIO inlier gate: s = 1 - 0.9 |pd| / sqrt(|p_l|)
        s = 1.0 - 0.9 * torch.abs(pd) / gate_den
        ok = valid & plane_ok & (s > 0.9) & (dists[:, 0] < 5.0)

        # d pd / d rot (right perturbation on R): n^T d(R Exp(d) p_b)/dd
        Rn = normals @ x.R                           # = R^T n, row convention
        z3 = torch.zeros_like(normals)
        if cfg.estimate_extrinsic:
            ext = [torch.linalg.cross(points_l, Rn @ x.R_LI), Rn]
        else:
            ext = [z3, z3]
        H = torch.cat([normals, torch.linalg.cross(p_b, Rn)] + ext
                      + [z3, z3, z3, z3[:, :2]], dim=-1)
        # masked rows are set to zero, so no non-finite value leaks through 0 * x
        z = torch.where(ok, pd, 0.0)
        z = torch.where(torch.isfinite(z), z, 0.0)
        H = torch.where(ok[:, None] & torch.isfinite(H), H, 0.0)
        if with_slots:
            live = valid & torch.all(torch.isfinite(p_w), dim=-1)
            return z, H, ok, torch.where(live[:, None], slots[0], -1)
        return z, H, ok

    return h_fn


class Rows(NamedTuple):
    """One evaluation's normal equations over the non-zero columns (6, or
    12 with the extrinsic), unweighted: N = sum h h^T, v = sum h z over the
    inliers; their count, sum z^2; the neighbour slots [M, 5]."""
    N: torch.Tensor
    v: torch.Tensor
    n_ok: torch.Tensor
    zz: torch.Tensor
    slots: torch.Tensor | None


def rows_plain(m: voxel_map.VoxelMap, points_l, valid, x: esekf.State, cfg,
               with_slots: bool = False) -> Rows:
    """What one ``lio_rows`` launch sums, from ``make_h_fn``'s closure at x."""
    nc = 12 if cfg.estimate_extrinsic else 6
    z, H, ok, *slots = make_h_fn(m, points_l, valid, cfg, with_slots)(x)
    Hk = H[:, :nc] * ok.to(H.dtype)[:, None]
    return Rows(H[:, :nc].T @ Hk, Hk.T @ z, count(ok), torch.sum(z * z),
                slots[0] if slots else None)


def fences_plain(keys: torch.Tensor, lg: int) -> torch.Tensor:
    """What ``lio_fences`` writes for the sorted pool keys [cap]: every
    2^lg-th key, then the number of them below the first kEmpty one (int32
    [ceil(cap / 2^lg) + 1])."""
    f = keys[::1 << lg]
    return torch.cat([f, count(f != voxel_map.EMPTY_KEY).reshape(1).to(torch.int32)])


def guard(filt0: esekf.Filter, filt: esekf.Filter):
    """The divergence guard: (filter, bad), the filter from before the scan
    where the update's state or P is not finite or |v| > 60 m/s."""
    stx = filt.x
    flat = torch.cat([stx.pos, stx.vel, stx.bg, stx.ba, stx.grav, stx.R.reshape(-1),
                      filt.P.reshape(-1)])
    bad = ~torch.all(torch.isfinite(flat)) | (torch.sum(stx.vel * stx.vel) > 60.0 ** 2)
    return esekf.Filter(
        esekf.State(*[torch.where(bad, a, b) for a, b in zip(filt0.x, filt.x)]),
        torch.where(bad, filt0.P, filt.P)), bad


class ScanUpdate(NamedTuple):
    filt: esekf.Filter            # the guarded filter
    n_iters: torch.Tensor         # [] int32
    bad: torch.Tensor             # [] bool
    points_world: torch.Tensor    # [M, 3] at the guarded state
    n_effective: torch.Tensor     # [] int32, inliers at the guarded state


def scan_update_plain(filt0: esekf.Filter, filt: esekf.Filter, m: voxel_map.VoxelMap,
                      points_l, valid, cfg) -> ScanUpdate:
    """The iterated point-to-plane update of a scan step, the guard back to
    ``filt0`` (the filter before the scan) and the inliers at the result."""
    h_fn = make_h_fn(m, points_l, valid, cfg)
    filt, n_iters = esekf.update_iterated(filt, h_fn, cfg.meas_cov, max_iters=cfg.max_iters)
    filt, bad = guard(filt0, filt)
    p_b = points_l @ filt.x.R_LI.T + filt.x.t_LI
    p_w = p_b @ filt.x.R.T + filt.x.pos
    _, _, ok = h_fn(filt.x)
    return ScanUpdate(filt, n_iters, bad, p_w, count(ok))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(what: str, x: torch.Tensor, shape, dtype, dev) -> None:
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"{what}: must be {dtype} {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda" or x.device != dev:
        raise ValueError(f"{what}: every tensor must lie on one CUDA device, got {x.device} "
                         f"beside {dev}")


def pack(f: esekf.Filter) -> torch.Tensor:
    """The filter as the kernels' [565] float32 (state, then P): the buffer
    itself where the filter is ``unpack``'s views of one (a kernel's
    output), else one concatenation."""
    fields = list(f.x) + [f.P]
    dev = f.P.device
    for (name, shape), t in zip(_SHAPES, f.x):
        _check(f"filter {name}", t, shape, torch.float32, dev)
    _check("filter P", f.P, (ERR_DIM, ERR_DIM), torch.float32, dev)
    base = f.x.pos
    offs, o = [], 0
    for t in fields:
        offs.append(o)
        o += t.numel()
    if all(t.is_contiguous() and t.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
           and t.data_ptr() == base.data_ptr() + 4 * off for t, off in zip(fields, offs)):
        return base.as_strided((PACKED_FLOATS,), (1,), base.storage_offset())
    return torch.cat([t.reshape(-1) for t in fields])


def unpack(buf: torch.Tensor) -> esekf.Filter:
    """Views of a [565] float32 buffer as a Filter."""
    return esekf.Filter(state_of(buf[:STATE_FLOATS]),
                        buf[STATE_FLOATS:].view(ERR_DIM, ERR_DIM))


def state_of(v: torch.Tensor) -> esekf.State:
    """The State of a [36] vector (views)."""
    parts, o = [], 0
    for _, shape in _SHAPES:
        n = 3 if len(shape) == 1 else 9
        parts.append(v[o:o + n].view(shape))
        o += n
    return esekf.State(*parts)


def state_vector(x: esekf.State) -> torch.Tensor:
    """A State as the kernels' [36]."""
    return torch.cat([t.reshape(-1) for t in x])


def _predict(f: esekf.Filter, gyro, acc, dts, noise: esekf.NoiseCfg, keys):
    global predict_launches, fence_launches
    N = gyro.shape[0]
    dev = gyro.device
    _check("esekf_predict gyro", gyro, (N, 3), torch.float32, dev)
    _check("esekf_predict acc", acc, (N, 3), torch.float32, dev)
    _check("esekf_predict dts", dts, (N,), torch.float32, dev)
    xin = pack(f)
    if xin.device != dev:
        raise ValueError(f"esekf_predict: the filter lies on {xin.device}, the window on {dev}")
    g, a, d = (t.contiguous() for t in (gyro, acc, dts))
    out = torch.empty(PACKED_FLOATS, dtype=torch.float32, device=dev)
    R_traj = torch.empty((N, 3, 3), dtype=torch.float32, device=dev)
    p_traj = torch.empty((N, 3), dtype=torch.float32, device=dev)
    lib = build.library()
    fences, fence_args = None, (None, 0, 0, None)
    if keys is not None:
        cap = keys.shape[0]
        _check("lio_fences pool keys", keys, (cap,), torch.int32, dev)
        keys = keys.contiguous()
        lg = lib.tc2li_lio_fence_log2(cap)
        fences = torch.empty(-(-cap // (1 << lg)) + 1, dtype=torch.int32, device=dev)
        fence_args = (keys.data_ptr(), cap, lg, fences.data_ptr())
    build.check(lib.tc2li_esekf_predict(
        xin.data_ptr(), g.data_ptr(), a.data_ptr(), d.data_ptr(), N, noise.gyr ** 2,
        noise.acc ** 2, noise.bg_rw ** 2, noise.ba_rw ** 2, out.data_ptr(), R_traj.data_ptr(),
        p_traj.data_ptr(), *fence_args, torch.cuda.current_stream(dev).cuda_stream),
        "esekf_predict")
    predict_launches += 1
    if keys is not None:
        fence_launches += 1
    return unpack(out), R_traj, p_traj, fences


def esekf_predict(f: esekf.Filter, gyro, acc, dts, noise: esekf.NoiseCfg):
    """Launch ``csrc/lio.cu``'s prediction on the current stream: what
    ``predict_plain`` computes, in one launch of one block and without a
    host sync."""
    return _predict(f, gyro, acc, dts, noise, None)[:3]


def predict_with_fences(f: esekf.Filter, gyro, acc, dts, noise: esekf.NoiseCfg,
                        keys: torch.Tensor):
    """``esekf_predict`` whose launch also writes the fence table of the
    sorted pool keys [cap] (``fences_plain``) by blocks of their own: the
    scan step's first launch. Returns (filter, R_traj, p_traj, the table
    int32 [ceil(cap / 2^lg) + 1]) for ``LioWork``."""
    return _predict(f, gyro, acc, dts, noise, keys)


class LioWork:
    """The device buffers of one scan step's update and its launches, in
    the order ``scan_update`` makes them: ``rows(0)``, ``step(0)``, ...,
    ``rows(k - 1)``, ``step(k - 1)``; ``rows(k)``, ``step(k, final=True)``;
    ``rows_last()``. ``filt0`` is the filter before the scan (the guard's
    fallback), ``filt`` the prediction; ``points_l`` [M, 3], ``valid`` [M];
    ``fences`` the pool keys' fence table that ``predict_with_fences``
    wrote. The rows and step launches are programmatic dependents of the
    launch before them on the stream: their blocks start while it ends and
    read nothing before its writes are done."""

    def __init__(self, filt0: esekf.Filter, filt: esekf.Filter, m: voxel_map.VoxelMap,
                 points_l, valid, cfg, fences: torch.Tensor):
        dev = points_l.device
        M = points_l.shape[0]
        _check("lio_rows points", points_l, (M, 3), torch.float32, dev)
        _check("lio_rows valid", valid, (M,), torch.bool, dev)
        _check("lio_rows map keys", m.keys, (m.capacity,), torch.int32, dev)
        _check("lio_rows map points", m.points, (m.capacity, 3), torch.float32, dev)
        _check("lio_rows map origin", m.origin, (3,), torch.float32, dev)
        self.x0p, self.xp = pack(filt0), pack(filt)
        for what, t in (("filter before the scan", self.x0p), ("prediction", self.xp)):
            if t.device != dev:
                raise ValueError(f"lio_rows: the {what} lies on {t.device}, the points on {dev}")
        self.m, self.cfg, self.M, self.dev = m, cfg, M, dev
        self.pl = points_l.contiguous()
        self.valid = valid.contiguous().view(torch.uint8)
        self.keys, self.mpts = m.keys.contiguous(), m.points.contiguous()
        self.ncols = 12 if cfg.estimate_extrinsic else 6
        self.entries = self.ncols * (self.ncols + 1) // 2 + self.ncols + 1
        self.lib = build.library()
        self.blocks = self.lib.tc2li_lio_rows_blocks(M)
        self.lg = self.lib.tc2li_lio_fence_log2(m.capacity)
        self.n_fences = -(-m.capacity // (1 << self.lg))
        f32, f64 = torch.float32, torch.float64
        # the fence table: every 2^lg-th pool key, then the count below kEmpty
        _check("lio_rows fence table", fences, (self.n_fences + 1,), torch.int32, dev)
        self.fence_table = fences
        self.partials = torch.empty(self.entries * self.blocks, dtype=f64, device=dev)   # [E, B]
        self.work = torch.empty(self.lib.tc2li_lio_work_doubles(), dtype=f64, device=dev)
        self.xs = torch.empty((max(cfg.max_iters, 1), STATE_FLOATS), dtype=f32, device=dev)
        self.out = torch.empty(PACKED_FLOATS, dtype=f32, device=dev)
        self.ints = torch.empty(2, dtype=torch.int32, device=dev)   # n_iters, n_effective
        self.bad = torch.empty(1, dtype=torch.uint8, device=dev)
        self.pw = torch.empty((M, 3), dtype=f32, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def state(self, i: int) -> torch.Tensor:
        """The float32 state an evaluation at iterate i reads."""
        return self.xp if i == 0 else self.xs[i - 1]

    def _rows(self, x: torch.Tensor, last: bool, slots) -> None:
        global rows_launches
        nbr = 0
        if slots is not None:
            _check("lio_rows slots", slots, (self.M, 5), torch.int32, self.dev)
            nbr = slots.data_ptr()
        build.check(self.lib.tc2li_lio_rows(
            x.data_ptr(), self.pl.data_ptr(), self.valid.data_ptr(), self.M,
            self.keys.data_ptr(), self.mpts.data_ptr(), self.m.origin.data_ptr(),
            self.m.capacity, self.fence_table.data_ptr(), self.lg, self.m.voxel_size,
            self.cfg.plane_thresh, self.ncols, int(last), self.partials.data_ptr(),
            self.pw.data_ptr(), self.ints[1:].data_ptr(), nbr, self.stream), "lio_rows")
        rows_launches += 1

    def rows(self, i: int, slots=None) -> None:
        """Evaluate the measurement at iterate i into the blocks' sums
        (``slots``: an int32 [M, 5] that takes the neighbours' pool slots)."""
        self._rows(self.state(i), False, slots)

    def rows_last(self, slots=None) -> None:
        """The last evaluation, at the guarded state: p_w and the inliers."""
        self._rows(self.out, True, slots)

    def step(self, i: int, final: bool = False) -> None:
        """The MAP step from iterate i (``final``: the covariance at it and
        the guard), after ``rows(i)``; ``step(0)`` keeps P0^-1 for the
        later ones."""
        global step_launches
        nxt = self.xs[min(i, self.xs.shape[0] - 1)]
        build.check(self.lib.tc2li_esekf_step(
            self.partials.data_ptr(), self.blocks, self.ncols, 1.0 / self.cfg.meas_cov, 1e-3,
            self.xp.data_ptr(), self.x0p.data_ptr(), int(i == 0), int(final),
            self.work.data_ptr(), nxt.data_ptr(), self.out.data_ptr(), self.ints.data_ptr(),
            self.bad.data_ptr(), self.stream), "esekf_step")
        step_launches += 1

    def sums(self):
        """The blocks' partial sums added (float64, in torch): N [nc, nc], v
        [nc], the inlier count; for checks beside the plain versions."""
        nc, T = self.ncols, self.ncols * (self.ncols + 1) // 2
        s = self.partials.view(self.entries, self.blocks).sum(1)
        iu = torch.triu_indices(nc, nc, device=self.dev)
        N = torch.zeros((nc, nc), dtype=torch.float64, device=self.dev)
        N[iu[0], iu[1]] = s[:T]
        N[iu[1], iu[0]] = s[:T]
        return N, s[T:T + nc], s[-1]

    def iterate(self) -> torch.Tensor:
        """The float64 iterate the step keeps between launches [36]."""
        ne = ERR_DIM ** 2
        return self.work[ne:ne + STATE_FLOATS]

    def result(self) -> ScanUpdate:
        return ScanUpdate(unpack(self.out), self.ints[0], self.bad.view(torch.bool)[0], self.pw,
                          self.ints[1])


def scan_update(filt0: esekf.Filter, filt: esekf.Filter, m: voxel_map.VoxelMap, points_l,
                valid, cfg, fences: torch.Tensor) -> ScanUpdate:
    """Launch ``csrc/lio.cu``'s update on the current stream: what
    ``scan_update_plain`` computes, in 2 max_iters + 3 launches and without
    a host sync, searching the pool through ``fences`` (the fence table
    ``predict_with_fences`` wrote for ``m``'s keys)."""
    w = LioWork(filt0, filt, m, points_l, valid, cfg, fences)
    for i in range(cfg.max_iters):
        w.rows(i)
        w.step(i)
    w.rows(cfg.max_iters)
    w.step(cfg.max_iters, final=True)
    w.rows_last()
    return w.result()
