#!/usr/bin/env python3
"""Device time of the ORB kernels of ``csrc/orb.cu`` on one card, for one
or several checkouts in turns.

    python3 tools/orb_kernels.py [--tree DIR ...] [--out DIR] [--stereo-only | --describe-only]

Renders frame 0 of ``chip_smoke.py``'s KITTI-shaped sequence (a 1241x376
stereo pair of the synthetic world) once, then for each tree (default: this
checkout; ``--tree A --tree B --tree B --tree A`` compares two trees in
turns on one card) imports that tree's ``tc2li_slam_torch`` in a child
process, builds its kernels and runs this checkout's
``chip_smoke.orb_kernel_rows`` on the pair: each kernel against its plain
version (bit for bit), device ms behind a device backlog beside its bound,
the plain version's ms and the library call's; then ``orb_hd_rows`` on the
pair resampled to 1280x720 and 1920x1080 (a tree whose kernels refuse that
size is reported so); and the device ms of each kernel name a call on the
KITTI pair (``chip_smoke.kernel_split``), ``orb_level_planes`` on the first
1, 2, 4, 6 and 8 levels of one and of two images, and the bound of the eager
``stereo.subpixel_refine`` on 2,000 keypoints (``chip_smoke.subpixel_bound``).
``fast_nms_planes`` is split apart at the three camera sizes
(``chip_smoke.nms_row``: bit-equal to its plain version, device ms behind a
backlog and by kernel name, its bound) and, where the tree's ``fast.cu``
has clock laps, by phase on the KITTI pair (``nms_phases``: thread 0 of
block 0 through the lapped build), and the stereo half of a frame build
(``ops/kernels/stereo.stereo_refine``: prep, the match, refine with the
gate; refine and gate apart in an older tree) is timed on the KITTI pair's
keypoints, device ms a call (three readings) and by kernel name, with the
refine launch's phases where the tree's ``stereo.cu`` has clock laps
(``stereo_phases``). ``orb_describe`` is timed again on the KITTI pair's
keypoints (``describe_rows``: bit-equal to its plain version on the
pair, an odd keypoint count and two small sizes, three readings behind a
backlog, its registers) and, where the tree's ``orb.cu`` has clock laps,
split by phase (``describe_phases``: thread 0 of block 0); the ORB half of
a frame build (``ops/orb.extract_images``, both images) is timed a call
(three readings; its host work sets that time) and by kernel name, with
its device ms a call, the sum. ``--stereo-only`` times the stereo half
alone, ``--describe-only`` ``describe_rows`` alone (~75 s a tree).
Prints one JSON object a tree,
with the card's name and power limit, and writes them to ``--out``."""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the lap slots of csrc/fast.cu's fast_nms_planes_kernel (laps.cuh)
NMS_LAPS = {0: "loads issued, cell flags and tables", 1: "pixels in, thresholded to shared memory",
            2: "suppression and stores"}
N_SLOTS = 64   # laps.cuh kLapSlots


def nms_phases(torch, imgs) -> dict | None:
    """Cycles of thread 0 of block 0 (plane 0's first tile) by phase of
    ``fast_nms_planes`` on the stacks of ``imgs``, through the lapped library
    (``build.variant("-DTC2LI_LAPS")``); None for a tree whose ``fast.cu``
    has no laps."""
    import ctypes
    from tc2li_slam_torch.ops.kernels import build, fast, orb as korb
    lapped = build.variant("-DTC2LI_LAPS")
    if not hasattr(lapped, "tc2li_laps_read_fast"):
        return None
    st, _, shapes = korb.orb_level_planes(imgs, 8, 1.2)
    gated, flags = fast.score_planes(st, shapes, korb.PAD)
    buf = (ctypes.c_longlong * (2 * N_SLOTS))()
    with build.routed_to(lapped):
        fast.nms_planes(gated, flags, shapes)
        torch.cuda.synchronize()
        lapped.tc2li_laps_reset_fast()
        fast.nms_planes(gated, flags, shapes)
        torch.cuda.synchronize()
        lapped.tc2li_laps_read_fast(buf)
    return {name: buf[k] for k, name in NMS_LAPS.items() if buf[N_SLOTS + k]}


# the lap slots of csrc/stereo.cu's refine_kernel (laps.cuh)
STEREO_LAPS = {0: "wait, inputs, left patch staged", 1: "matcher's tail, right strip staged",
               2: "SADs", 3: "arg-min, parabola, outputs", 4: "published, counted in",
               5: "the last block's median gate"}


def stereo_phases(torch, half) -> dict | None:
    """Cycles of thread 0 of block 0 by phase of the stereo half's refine
    launch (``half()`` a call of ``stereo_refine``), through the lapped
    library; None for a tree whose ``stereo.cu`` has no laps."""
    import ctypes
    from tc2li_slam_torch.ops.kernels import build
    lapped = build.variant("-DTC2LI_LAPS")
    if not hasattr(lapped, "tc2li_laps_read_stereo"):
        return None
    buf = (ctypes.c_longlong * (2 * N_SLOTS))()
    with build.routed_to(lapped):
        half()
        torch.cuda.synchronize()
        lapped.tc2li_laps_reset_stereo()
        half()
        torch.cuda.synchronize()
        lapped.tc2li_laps_read_stereo(buf)
    return {name: buf[k] for k, name in STEREO_LAPS.items() if buf[N_SLOTS + k]}


# the lap slots of csrc/orb.cu's describe_kernel (laps.cuh)
DESCRIBE_LAPS = {0: "indices (and the pattern) in", 1: "patch loads and column sums",
                 2: "the cross-lane sum", 3: "the angle, its sine and cosine",
                 4: "the taps and the ballots"}


def describe_phases(torch, imgs) -> dict | None:
    """Cycles of thread 0 of block 0 by phase of ``orb_describe`` on the
    keypoints of ``imgs`` (the grid top-k of 2,000 features an image),
    through the lapped library; None for a tree whose ``orb.cu`` has no
    laps."""
    import ctypes
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import build, fast, orb as korb
    lapped = build.variant("-DTC2LI_LAPS")
    if not hasattr(lapped, "tc2li_laps_read_orb"):
        return None
    st, bl, shapes = korb.orb_level_planes(imgs, 8, 1.2)
    scores = fast.detect_planes(st, shapes, korb.PAD)
    rows, cols, _, level, _ = korb.orb_select_grid(
        scores, shapes, orb.features_per_level(2000, 8, 1.2), 1.2)
    call = lambda: korb.orb_describe(st, bl, rows, cols, level, 8, korb.PAD)
    buf = (ctypes.c_longlong * (2 * N_SLOTS))()
    with build.routed_to(lapped):
        call()
        torch.cuda.synchronize()
        lapped.tc2li_laps_reset_orb()
        call()
        torch.cuda.synchronize()
        lapped.tc2li_laps_read_orb(buf)
    return {name: buf[k] for k, name in DESCRIBE_LAPS.items() if buf[N_SLOTS + k]}


def describe_rows(torch, chip_smoke, pair) -> dict:
    """``orb_describe`` against ``describe_plain`` bit for bit and the same
    bits twice, on the KITTI pair with one and two images, a keypoint count
    that is not a multiple of the kernel's keypoints a warp (1,001 an
    image) and on smoothed noise at 64x64 and 101x203; then on the pair's
    4,000 keypoints its device ms behind a backlog (three readings), its
    phases (``describe_phases``), its registers and spills as ptxas
    reported them, and the ORB half of a frame build
    (``ops/orb.extract_images``): ms a call (three readings; its host work
    sets that time) and device ms a call by kernel name, and their sum."""
    import numpy as np
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import build, fast, orb as korb
    dev = pair[0].device
    rng = np.random.default_rng(0)
    cases = [("KITTI pair", torch.stack(pair), None), ("KITTI pair, 1,001 an image",
                                                        torch.stack(pair), 1001)]
    for shape in ((64, 64), (101, 203)):
        im = rng.integers(0, 256, (2, *shape)).astype(np.float32)
        im[0] = (im[0] + np.roll(im[0], 1, 0) + np.roll(im[0], 1, 1)) / 3
        cases.append((f"{shape[1]}x{shape[0]}", torch.as_tensor(im).to(dev), None))
    checks = []
    for name, imgs, cut in cases:
        for B in (1, 2):
            st, bl, shapes = korb.orb_level_planes(imgs[:B].contiguous(), 8, 1.2)
            scores = fast.detect_planes(st, shapes, korb.PAD)
            per = orb.features_per_level(2000 if imgs.shape[1] > 300 else 500, 8, 1.2)
            rows, cols, _, level, _ = korb.orb_select_grid(scores, shapes, per, 1.2)
            if cut:
                rows, cols, level = (x[:, :cut].contiguous() for x in (rows, cols, level))
            got = korb.orb_describe(st, bl, rows, cols, level, 8, korb.PAD)
            again = korb.orb_describe(st, bl, rows, cols, level, 8, korb.PAD)
            ref = korb.describe_plain(st, bl, rows, cols, level, 8, korb.PAD)
            off = (got[0].view(torch.int32) != ref[0].view(torch.int32)) | (got[1] != ref[1]).any(-1)
            checks.append({"case": name, "images": B, "keypoints": rows.numel(),
                           "bit-equal": chip_smoke.bit_equal(torch, got, ref),
                           "the same bits twice": chip_smoke.bit_equal(torch, got, again),
                           "keypoints off": int(off.sum())})
    imgs = torch.stack(pair)
    st, bl, shapes = korb.orb_level_planes(imgs, 8, 1.2)
    scores = fast.detect_planes(st, shapes, korb.PAD)
    sel = korb.orb_select_grid(scores, shapes, orb.features_per_level(2000, 8, 1.2), 1.2)
    desc = lambda: korb.orb_describe(st, bl, sel[0], sel[1], sel[3], 8, korb.PAD)
    log = build.ptxas_log.splitlines()
    ptxas = [x.split(":", 1)[-1].strip() for i, line in enumerate(log)
             if "Compiling entry function" in line and "describe_kernel" in line
             for x in log[i + 1:i + 6] if "Used" in x or "spill" in x]
    u8 = [x.to(torch.uint8) for x in pair]
    half = lambda: orb.extract_images(u8, 2000, 8)
    split = chip_smoke.kernel_split(torch, half, 20)
    return {"checks": checks, "keypoints": sel[0].numel(),
            "ms": [chip_smoke.cuda_ms(torch, desc, 50, True) for _ in range(3)],
            "phases": describe_phases(torch, imgs), "ptxas": ptxas,
            "orb_half": {"ms": [chip_smoke.cuda_ms(torch, half, 50, True) for _ in range(3)],
                         "device ms": sum(v["ms_a_launch"] * v["launches_a_call"]
                                          for v in split.values()),
                         "split": {k: v["ms_a_launch"] for k, v in split.items()},
                         "launches": {k: v["launches_a_call"] for k, v in split.items()}}}


def render_pair(path: Path) -> None:
    """Frame 0's stereo pair of chip_smoke.py's sequence, uint8 [2, H, W]."""
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from tc2li_slam_torch.io import synthetic as syn
    world = syn.make_world(np.random.default_rng(0), n_surf=300_000)
    traj = syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0))
    T_wb = syn.trajectory_poses(traj, 1)[0]
    l, r = syn.render_stereo(syn.World(planes=world.planes, surf=None), syn.KITTI_LIKE, T_wb)
    np.save(path, np.stack([np.clip(l, 0, 255), np.clip(r, 0, 255)]).astype(np.uint8))


def measure(tree: Path, pair_path: Path, stereo_only: bool = False,
            describe_only: bool = False) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    # this checkout's chip_smoke (its helpers), the tree's package
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import tc2li_slam_torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    pair = [torch.as_tensor(x).to(dev).to(torch.float32) for x in np.load(pair_path)]
    log = []
    out = {"tree": str(Path(tc2li_slam_torch.__file__).resolve().parents[1]),
           "card": chip_smoke.nvidia_smi_line()}
    from tc2li_slam_torch.ops import orb
    if describe_only:
        out["orb_describe"] = describe_rows(torch, chip_smoke, pair)
        return out
    if not stereo_only:
        orb_rows(torch, chip_smoke, pair, out, log)
    # the stereo half of a frame build on the pair (prep, the match, refine
    # and gate): device ms a call behind a backlog and by kernel name
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops.kernels import stereo as kst
    u8 = [x.to(torch.uint8) for x in pair]
    kl, kr = orb.extract_images(u8, 2000, 8)
    sf = (1.2 ** torch.arange(8, dtype=torch.float64)).to(torch.float32).to(dev)
    rig = syn.KITTI_LIKE
    bf = float(np.float32(rig.fx) * np.float32(rig.baseline))
    half = lambda: kst.stereo_refine(u8[0], u8[1], kl, kr, sf, bf, rig.baseline)
    split = chip_smoke.kernel_split(torch, half, 20)
    out["stereo_half"] = {"ms": [chip_smoke.cuda_ms(torch, half, 50, True) for _ in range(3)],
                          "split": {k: v["ms_a_launch"] for k, v in split.items()},
                          "launches": {k: v["launches_a_call"] for k, v in split.items()},
                          "refine phases": stereo_phases(torch, half)}
    out["log"] = log
    return out


def orb_rows(torch, chip_smoke, pair, out: dict, log) -> None:
    """The ORB kernels' rows, splits and sizes into ``out``."""
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import fast, orb as korb
    out["kitti"] = chip_smoke.orb_kernel_rows(torch, pair, log=log.append, hd_size=None)
    # device ms a call by kernel name (the grid top-k's two launches apart)
    imgs = torch.stack(pair)
    st, _, shapes = korb.orb_level_planes(imgs, 8, 1.2)
    scores = fast.detect_planes(st, shapes, korb.PAD)
    per = orb.features_per_level(2000, 8, 1.2)
    out["split"] = {
        "orb_level_planes": chip_smoke.kernel_split(
            torch, lambda: korb.orb_level_planes(imgs, 8, 1.2), 20),
        "orb_select_grid": chip_smoke.kernel_split(
            torch, lambda: korb.orb_select_grid(scores, shapes, per, 1.2), 20)}
    import torch.nn.functional as F
    out["fast_nms_planes"] = {"1241x376": chip_smoke.nms_row(torch, imgs)}
    out["fast_nms_planes_phases"] = nms_phases(torch, imgs)
    for H, W in ((720, 1280), (1080, 1920)):
        big = F.interpolate(imgs[:, None], size=(H, W), mode="bilinear",
                            antialias=True)[:, 0].round().clamp(0, 255).contiguous()
        out["fast_nms_planes"][f"{W}x{H}"] = chip_smoke.nms_row(torch, big)
        try:
            out[f"{W}x{H}"] = chip_smoke.orb_hd_rows(torch, pair, (H, W), log=log.append)
        except ValueError as e:
            out[f"{W}x{H}"] = {"refused": str(e)}
    # orb_level_planes by image and level count: where the launch's time goes
    out["level_planes_by_levels"] = {
        f"{B} image(s), {nl} level(s)": chip_smoke.cuda_ms(
            torch, lambda x=imgs[:B].contiguous(), nl=nl: korb.orb_level_planes(x, nl, 1.2), 50,
            True)
        for B in (1, 2) for nl in (1, 2, 4, 6, 8)}
    out["subpixel_refine_bound_2000"] = chip_smoke.subpixel_bound(2000)
    out["orb_describe"] = describe_rows(torch, chip_smoke, pair)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--out", default=str(ROOT / "build" / "orb_kernels"))
    ap.add_argument("--stereo-only", action="store_true",
                    help="time the stereo half of a frame build alone")
    ap.add_argument("--describe-only", action="store_true",
                    help="orb_describe and the ORB half of a frame build alone")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(Path(args.child[0]).resolve(), Path(args.child[1]),
                                 args.stereo_only, args.describe_only)), flush=True)
        return 0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    pair_path = out / "pair.npy"
    render_pair(pair_path)
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--child", tree, str(pair_path)]
                             + (["--stereo-only"] if args.stereo_only else [])
                             + (["--describe-only"] if args.describe_only else []),
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        (out / f"orb_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
