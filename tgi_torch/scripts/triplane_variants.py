"""The tri-plane gather and splat kernels, the sorted splat, the
scheduled splat and the tile walk timed beside other versions of their
sources, on the main path's own inputs, on a CUDA card.

    python -m tgi_torch.scripts.triplane_variants [--variants DIR ...]
        [--out FILE.json]

Each ``DIR`` holds some of ``triplane_gather.cu``,
``triplane_splat.cu``, ``triplane_splat_sorted.cu``, ``splat_sched.cu``
and ``gather_tilewalk.cu`` with the committed files' C entry points: an
earlier commit's file, or a copy edited to try one change. The
directory's name is the variant's name. Every variant is built with the
package's ``nvcc`` flags into ``tgi_torch/_build/variants/``. A
``triplane_splat_sorted.cu`` of the earlier design (a cell kernel
``tgi_splat_cells_f32`` with one entry per point and corner,
``torch.sort`` per plane and ``torch.searchsorted``, then a segment
kernel that reads the coords) runs behind an adapter here
(:func:`earlier_sorted_fns`).

The script renders with the full-width generator
(``GeneratorConfig(neural_rendering_resolution=128)``, weights drawn
from seed 0) from two cameras: ``chip_smoke.py``'s, at yaw +0.35, where
a ray's consecutive samples rarely share a cell on any plane, and a
frontal one, where they mostly do on the plane that faces the camera. It
keeps the planes and points of each render's two sampling passes, coarse
and fine (N = 1, 3 x 32 x 256², M = 786,432), and adds the splat bench's
points (``bench_splat_sched.make_inputs``: a 64² x 48 frustum march
clipped to the box, M = 196,608, whose clipped points pile into the
border cells) on the first render's coarse planes, each with a feature
gradient drawn from seed 1. On them it checks every version against the
plain one (the gather to 1e-5 abs, the splats to 1e-5 of the largest
value) and times it (CUDA-event medians, ``scripts.median_ms``) beside
the committed kernels, their scalar path (the same library, given
planes, g and out one float past a 16-byte boundary), the library call
(``F.grid_sample``, ``grid_sampler_2d_backward``) and the byte bound at
an H100 SXM's 3.35 TB/s; the sorted splat whole, its prep and its
segment kernel apart. The scheduled splat runs on the splat bench's
entries at both of ``chip_smoke.py``'s point counts (a 128² and a 64² x
48 frustum march on 256² planes), each schedule beside ``index_add_``.
The tile walk runs on the gather bench's inputs
(``bench_gather_vmem.make_inputs``) at the same two point counts, bf16
and fp32, in block-local and in ray-major order: every version is held
bit for bit against ``gather_rows_plain`` and its passes against
``tilewalk_passes_plain``, then timed without passes (the committed one
also with them) beside torch indexing of the same rows,
``gather_rows.cu`` on the same bytes (row-major cells) and the byte
bound. The versions run in turns, in order and then in reverse, and each
time is the mean of the two medians."""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import torch

from tgi_torch.ops import _native
from tgi_torch.ops import grid_sample as gs
from tgi_torch.scripts import median_ms

SOURCES = ("triplane_gather.cu", "triplane_splat.cu",
           "triplane_splat_sorted.cu", "splat_sched.cu",
           "gather_tilewalk.cu")
# The gather bench's point layouts (rays Ry x Rx, S samples) on 256²
# planes: P = 786,432 and 196,608, as chip_smoke.py's BENCH_LAYOUTS.
TILEWALK_LAYOUTS = ((128, 128, 48), (64, 64, 48))
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
# The earlier sorted splat's C entry points.
EARLIER_SORTED = {
    # coords, cells, N, H, W, M, scale, stream
    "tgi_splat_cells_f32": [_P, _P, _I, _I, _I, _L, _F, _P],
    # g, coords, order, offsets, d_planes, N, H, W, C, M, scale, stream
    "tgi_splat_segments_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _F,
                               _P],
}
TOL = 1e-5
BW = 3.35e12  # an H100 SXM's device-memory rate, bytes/s


def build_variants(dirs):
    """{(src, name): CDLL} for every source of SOURCES found in a
    directory of ``dirs``, all built at once."""
    out_dir = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for d in dirs:
        name = os.path.basename(os.path.normpath(d))
        for src in SOURCES:
            path = os.path.join(d, src)
            if not os.path.exists(path):
                continue
            so = os.path.join(out_dir, f"{name}-{src[:-3]}.so")
            cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-o", so, path]
            procs[src, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for (src, name), (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}/{src}: nvcc exited {proc.returncode}"
                             f"\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}/{src}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(so)
        entry_points = _native.ENTRY_POINTS[src]
        if hasattr(lib, "tgi_splat_cells_f32"):
            entry_points = EARLIER_SORTED
        for fn, argtypes in entry_points.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[src, name] = lib
    return libs


def main_path_passes(yaw, seed=0):
    """[(planes [N,3,C,H,W], coords [N,M,3], box_warp)] of the coarse and
    fine passes of one full-width render, the camera ``yaw`` off
    frontal."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    dev = "cuda"
    G = TriPlaneGenerator(GeneratorConfig(neural_rendering_resolution=128))
    params = G.init(torch.Generator().manual_seed(seed), device=dev)
    pivot = torch.tensor([0, 0, 0.2], device=dev)
    intr = fov_to_intrinsics(18.837, device=dev)
    cond = pack_camera(look_at_pose(math.pi / 2, math.pi / 2, pivot,
                                    radius=2.7, device=dev)[None], intr)
    cam = pack_camera(look_at_pose(math.pi / 2 + yaw, math.pi / 2, pivot,
                                   radius=2.7, device=dev)[None], intr)
    seen = []

    def record(planes, coords, box_warp):
        seen.append((planes, coords, box_warp))
        return gs.sample_triplanes(planes, coords, box_warp)

    renderer.sample_triplanes = record
    try:
        with torch.no_grad():
            ws = G.mapping(params, seed_z(0, G.cfg.z_dim, dev), cond,
                           truncation_psi=0.7, truncation_cutoff=14)
            G.synthesis(params, ws, cam, det=True)
    finally:
        renderer.sample_triplanes = gs.sample_triplanes
    return seen


def off_by_one_float(t):
    """``t``'s values in storage that starts one float past a 16-byte
    boundary (the kernels' scalar path)."""
    flat = torch.zeros(t.numel() + 1, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def gather_run(lib, planes_cl, coords, out, scale):
    N, _, H, W, C = planes_cl.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.tgi_triplane_gather_f32(
            planes_cl.data_ptr(), coords.data_ptr(), out.data_ptr(), N, H, W,
            C, coords.shape[1], scale, stream)
        if err:
            raise RuntimeError(f"gather launch failed ({err})")
    return run


def splat_run(lib, planes_cl, coords, g, d_planes, d_coords, scale):
    N, _, H, W, C = planes_cl.shape
    stream = torch.cuda.current_stream().cuda_stream
    need = d_coords is not None

    def run():
        err = lib.tgi_triplane_splat_f32(
            g.data_ptr(), coords.data_ptr(),
            planes_cl.data_ptr() if need else None, d_planes.data_ptr(),
            d_coords.data_ptr() if need else None, N, H, W, C,
            coords.shape[1], scale, 1, stream)
        if err:
            raise RuntimeError(f"splat launch failed ({err})")
    return run


def sorted_fns(lib, coords, g, scale, H, W):
    """{"whole", "prep", "segments": fn} of a sorted splat source with
    the committed entry points (keys, one stable sort, offsets and
    records, segments), and the d_planes that "whole" and "segments"
    write."""
    N, M, _ = coords.shape
    C = g.shape[3]
    dev = coords.device
    stream = torch.cuda.current_stream().cuda_stream
    keys = torch.empty(N * 3 * M, dtype=torch.int32, device=dev)
    offsets = torch.empty((N * 3, (H + 1) * (W + 1) + 1), dtype=torch.int32,
                          device=dev)
    records = torch.empty((N * 3 * M, 4), dtype=torch.int32, device=dev)
    d_planes = torch.full((N, 3, H, W, C), math.nan, device=dev)

    def prep():
        if lib.tgi_splat_keys_f32(coords.data_ptr(), keys.data_ptr(), N, H,
                                  W, M, scale, stream):
            raise RuntimeError("keys launch failed")
        keys_s, order = torch.sort(keys, stable=True)
        if lib.tgi_splat_offsets_f32(
                keys_s.data_ptr(), order.data_ptr(), coords.data_ptr(),
                offsets.data_ptr(), records.data_ptr(), N, H, W, M, scale,
                stream):
            raise RuntimeError("offsets launch failed")

    def segments():
        if lib.tgi_splat_segments_f32(g.data_ptr(), records.data_ptr(),
                                      offsets.data_ptr(), d_planes.data_ptr(),
                                      N, H, W, C, M, stream):
            raise RuntimeError("segments launch failed")

    def whole():
        prep()
        segments()
    return {"whole": whole, "prep": prep, "segments": segments}, d_planes


def earlier_sorted_fns(lib, coords, g, scale, H, W):
    """:func:`sorted_fns` for the earlier design: one int32 cell per
    (plane, point, corner), ``torch.sort`` of each plane's entries,
    ``torch.searchsorted`` for the offsets, a segment kernel that walks
    each cell's entries and re-reads their coords."""
    N, M, _ = coords.shape
    C = g.shape[3]
    dev = coords.device
    stream = torch.cuda.current_stream().cuda_stream
    cells = torch.empty((N * 3, 4 * M), dtype=torch.int32, device=dev)
    bounds = torch.arange(H * W + 1, dtype=torch.int32, device=dev).expand(
        N * 3, -1).contiguous()
    d_planes = torch.full((N, 3, H, W, C), math.nan, device=dev)
    sorted_ = {}

    def prep():
        if lib.tgi_splat_cells_f32(coords.data_ptr(), cells.data_ptr(), N, H,
                                   W, M, scale, stream):
            raise RuntimeError("cells launch failed")
        cell_s, sorted_["order"] = torch.sort(cells, dim=-1, stable=True)
        sorted_["offsets"] = torch.searchsorted(cell_s, bounds,
                                                out_int32=True)

    def segments():
        if lib.tgi_splat_segments_f32(
                g.data_ptr(), coords.data_ptr(), sorted_["order"].data_ptr(),
                sorted_["offsets"].data_ptr(), d_planes.data_ptr(), N, H, W,
                C, M, scale, stream):
            raise RuntimeError("segments launch failed")

    def whole():
        prep()
        segments()
    return {"whole": whole, "prep": prep, "segments": segments}, d_planes


def time_sorted(libs, coords, g, bwarp, H, W, library, row):
    """The sorted splat's versions on one pass: {"whole" | "prep" |
    "segments": {version: ms}}; errors into ``row["err"]``."""
    scale = 2.0 / bwarp
    want = gs.triplane_splat_sorted_plain(coords, g, bwarp, H, W)
    versions = {"committed": (_native.library("triplane_splat_sorted.cu"),
                              g),
                "committed, scalar path": (
                    _native.library("triplane_splat_sorted.cu"),
                    off_by_one_float(g))}
    versions.update({name: (lib, g) for (src, name), lib in libs.items()
                     if src == "triplane_splat_sorted.cu"})
    out = {"whole": {"grid_sampler_2d_backward": library}, "prep": {},
           "segments": {}}
    for name, (lib, gg) in versions.items():
        make = (earlier_sorted_fns if hasattr(lib, "tgi_splat_cells_f32")
                else sorted_fns)
        fns, d_planes = make(lib, coords, gg, scale, H, W)
        fns["whole"]()
        again = d_planes.clone()
        fns["whole"]()
        err = row["err"][f"sorted {name}"] = rel_err(d_planes, want)
        if not (err <= TOL and torch.equal(d_planes, again)):
            raise SystemExit(f"sorted {name!r} disagrees with plain by {err} "
                             f"of its largest value, or with itself")
        for part, fn in fns.items():
            out[part][name] = fn
    return {part: in_turns(fns) for part, fns in out.items()}


def time_sched(libs, gen_inputs):
    """The scheduled splat's versions on the splat bench's entries at
    both point counts: {case: {version: ms}}, the bounds and errors."""
    from tgi_torch.ops import splat_sched as ss
    from tgi_torch.scripts import bench_splat_sched as bench
    versions = {"committed": _native.library("splat_sched.cu")}
    versions.update({name: lib for (src, name), lib in libs.items()
                     if src == "splat_sched.cu"})
    stream = torch.cuda.current_stream().cuda_stream
    res = {"ms": {}, "bound_ms": {}, "err": {}}
    for Ry, Rx, S in ((128, 128, 48), (64, 64, 48)):
        t = gen_inputs(Ry, Rx, S)
        rows, wg, R = t["rows"], t["wg"], t["H"]
        G, P = rows.shape
        for schedule in ss.SCHEDULES:
            case = f"{schedule} P={P}"
            want = ss.splat_sched_plain(rows, wg, R, R, schedule)
            kept = ss.schedule_mask(rows, R, R, schedule).sum().item()
            nbytes = 2 * 128 * kept + 4 * G * P + 4 * 128 * G * R * R
            res["bound_ms"][case] = nbytes / BW * 1e3
            fns = {"index_add_": lambda t=t: bench.index_add(t)}
            for name, lib in versions.items():
                def run(lib=lib, schedule=schedule):
                    acc = torch.zeros((G, R * R, 128), device=rows.device)
                    if lib.tgi_splat_sched(
                            wg.data_ptr(), rows.data_ptr(), acc.data_ptr(), G,
                            P, R, R, ss.SCHEDULES.index(schedule), stream):
                        raise RuntimeError("splat_sched launch failed")
                    return acc
                err = res["err"][f"{case} {name}"] = rel_err(run(), want)
                if not err <= TOL:
                    raise SystemExit(f"splat_sched {name!r} {case} disagrees "
                                     f"with plain by {err}")
                fns[name] = run
            res["ms"][case] = in_turns(fns)
    return res


def _bits(t):
    """``t``'s bits, so that equality is bitwise (bf16 as int16)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def time_tilewalk(libs):
    """The tile walk's versions on the gather bench's inputs: {case:
    {version: ms}}, the bounds and the mean passes per block."""
    from tgi_torch.ops import gather_rows as gr
    from tgi_torch.scripts import bench_gather_vmem as bench
    versions = {"committed": _native.library("gather_tilewalk.cu")}
    versions.update({name: lib for (src, name), lib in libs.items()
                     if src == "gather_tilewalk.cu"})
    fetch = _native.library("gather_rows.cu")
    stream = torch.cuda.current_stream().cuda_stream

    def walk(name, exp, cells, out, passes=None):
        G, HW, L = exp.shape

        def run():
            err = versions[name].tgi_gather_tilewalk(
                exp.data_ptr(), cells.data_ptr(), out.data_ptr(),
                None if passes is None else passes.data_ptr(), G, HW,
                cells.shape[1], L * exp.element_size(), stream)
            if err:
                raise RuntimeError(f"gather_tilewalk {name!r} launch failed "
                                   f"({err})")
        return run

    def rows(exp, cells, out):
        G, HW, L = exp.shape

        def run():
            if fetch.tgi_gather_rows(exp.data_ptr(), cells.data_ptr(),
                                     out.data_ptr(), G, HW, cells.shape[1],
                                     L * exp.element_size(), stream):
                raise RuntimeError("gather_rows launch failed")
        return run

    res = {"ms": {}, "bound_ms": {}, "passes_per_block": {}}
    for Ry, Rx, S in TILEWALK_LAYOUTS:
        t = bench.make_inputs("cuda", Ry, Rx, S, 256)
        G, HW, L = t["exp32"].shape
        P = Ry * Rx * S
        for dt, exp, exp_t in (("bf16", t["exp16"], t["exp16_t"]),
                               ("fp32", t["exp32"], t["exp32_t"])):
            # out + plane + int32 cells, each once
            nbytes = exp.element_size() * L * (G * P + G * HW) + 4 * G * P
            for order, key in (("block-local", "cells_tiled_blocked"),
                               ("ray-major", "cells_tiled")):
                case = f"{dt} {order} P={P}"
                cells = t[key]
                idx = cells.long()
                want = gr.gather_rows_plain(exp_t, cells)
                n_want = gr.tilewalk_passes_plain(cells, HW)
                fns = {"torch indexing": lambda exp_t=exp_t, idx=idx:
                       exp_t[t["plane_idx"], idx],
                       "gather_rows.cu, row-major cells": rows(
                           exp, t["cells"], torch.empty_like(want))}
                for name in versions:
                    out = torch.full_like(want, math.nan)
                    n = torch.full_like(n_want, -1)
                    walk(name, exp_t, cells, out, n)()
                    if not (torch.equal(_bits(out), _bits(want))
                            and torch.equal(n, n_want)):
                        raise SystemExit(f"gather_tilewalk {name!r} {case} "
                                         f"differs from plain")
                    fns[name] = walk(name, exp_t, cells, out)
                fns["committed, with passes"] = walk(
                    "committed", exp_t, cells, torch.empty_like(want),
                    torch.empty_like(n_want))
                res["ms"][case] = in_turns(fns)
                res["bound_ms"][case] = nbytes / BW * 1e3
                res["passes_per_block"][case] = n_want.float().mean().item()
                del fns, out
    return res


def in_turns(fns):
    """{name: ms}: every fn timed in order, then in reverse; the mean of
    its two medians."""
    dev = torch.device("cuda")
    first = {k: median_ms(f, dev) for k, f in fns.items()}
    second = {k: median_ms(fns[k], dev) for k in reversed(list(fns))}
    return {k: (first[k] + second[k]) / 2 for k in fns}


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1)).item()


def time_pass(libs, planes, coords, bwarp, gen):
    """{kernel: {version: ms}}, the bounds and every version's error
    against plain, on one sampling pass."""
    import torch.nn.functional as F
    planes_cl = planes.permute(0, 1, 3, 4, 2).contiguous()
    N, _, H, W, C = planes_cl.shape
    M = coords.shape[1]
    scale = 2.0 / bwarp
    g = torch.randn((N, 3, M, C), generator=gen, device="cuda")
    inputs = {"": (planes_cl, g),
              " (scalar path)": (off_by_one_float(planes_cl),
                                 off_by_one_float(g))}
    nchw = planes_cl.permute(0, 1, 4, 2, 3).reshape(N * 3, C, H, W)
    nchw = nchw.contiguous()
    grid = gs.project_onto_planes(scale * coords).reshape(N * 3, 1, M, 2)
    g_lib = g.reshape(N * 3, M, C).permute(0, 2, 1).reshape(
        N * 3, C, 1, M).contiguous()
    # Each input read once, each output written once; the splat's
    # d_coords also reads the planes and writes d_coords.
    nbytes = 4 * (N * 3 * C * H * W + N * M * 3 + N * 3 * M * C)
    extra = 4 * (N * 3 * C * H * W + N * M * 3)
    row = {"bound_ms": {"gather": nbytes / BW * 1e3,
                        "splat": nbytes / BW * 1e3,
                        "splat_d_coords": (nbytes + extra) / BW * 1e3},
           "err": {}}

    def versions(src):
        yield "committed", _native.library(src), ""
        yield "committed, scalar path", _native.library(src), " (scalar path)"
        for (s, name), lib in libs.items():
            if s == src:
                yield name, lib, ""

    want = gs.sample_triplanes_plain(planes, coords, bwarp)
    fns = {"F.grid_sample": lambda: F.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=False)}
    for name, lib, how in versions("triplane_gather.cu"):
        out = torch.full_like(want, math.nan)  # what is not written fails
        out = off_by_one_float(out) if how else out
        fns[name] = gather_run(lib, inputs[how][0], coords, out, scale)
        fns[name]()
        err = row["err"][f"gather {name}"] = (out - want).abs().max().item()
        if not err <= TOL:
            raise SystemExit(f"gather {name!r} disagrees with plain by {err}")
    row["gather"] = in_turns(fns)
    want_p, want_c = gs.triplane_splat_plain(planes_cl, coords, g, bwarp,
                                             True)
    for key, need in (("splat", False), ("splat_d_coords", True)):
        fns = {"grid_sampler_2d_backward": lambda need=need: torch.ops.aten.
               grid_sampler_2d_backward(g_lib, nchw, grid, 0, 0, False,
                                        [True, need])}
        for name, lib, how in versions("triplane_splat.cu"):
            pl, gg = inputs[how]
            dp = torch.empty_like(planes_cl)
            dc = torch.full_like(coords, math.nan) if need else None
            fns[name] = splat_run(lib, pl, coords, gg, dp, dc, scale)
            fns[name]()
            err = max([rel_err(dp, want_p)] +
                      ([rel_err(dc, want_c)] if need else []))
            row["err"][f"{key} {name}"] = err
            if not err <= TOL:
                raise SystemExit(f"{key} {name!r} disagrees with plain by "
                                 f"{err} of its largest value")
        row[key] = in_turns(fns)
    for part, ms in time_sorted(
            libs, coords, g, bwarp, H, W,
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_lib, nchw, grid, 0, 0, False, [True, False]), row).items():
        row[f"sorted {part}"] = ms
        row["bound_ms"][f"sorted {part}"] = row["bound_ms"]["splat"]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="*", default=[],
                    help="directories of other versions of the sources "
                    "(triplane_gather.cu, triplane_splat.cu, "
                    "triplane_splat_sorted.cu, splat_sched.cu, "
                    "gather_tilewalk.cu)")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("triplane_variants needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    _native.build_all()
    libs = build_variants(args.variants)
    results = {"card": card, "passes": {}}
    gen = torch.Generator(device="cuda").manual_seed(1)
    passes = {f"{name}, {kind}": seen
              for name, yaw in (("yaw +0.35", 0.35), ("frontal", 0.0))
              for kind, seen in zip(("coarse", "fine"),
                                    main_path_passes(yaw))}
    from tgi_torch.scripts import bench_splat_sched as bench
    passes["splat bench's points"] = (passes["yaw +0.35, coarse"][0],
                                      bench.make_inputs("cuda")["points"],
                                      bench.BOX_WARP)
    for pname, (planes, coords, bwarp) in passes.items():
        row = results["passes"][pname] = time_pass(libs, planes, coords,
                                                   bwarp, gen)
        for key in ("gather", "splat", "splat_d_coords", "sorted whole",
                    "sorted prep", "sorted segments"):
            lib_name = ("F.grid_sample" if key == "gather"
                        else "grid_sampler_2d_backward")
            lib_ms = (row[key].get(lib_name)
                      or row["sorted whole"]["grid_sampler_2d_backward"])
            bound = row["bound_ms"][key]
            print(f"{pname} pass, {key} (M={coords.shape[1]}, bound "
                  f"{bound:.4f} ms):", flush=True)
            for k, ms in row[key].items():
                print(f"  {ms:8.4f} ms  x{ms / lib_ms:5.2f} of "
                      f"{lib_name}  {100 * bound / ms:5.1f} % of bound  {k}",
                      flush=True)
        print(f"{pname} pass, max errors against plain: "
              f"{max(row['err'].values()):.3g}", flush=True)
    sched = results["splat_sched"] = time_sched(
        libs, lambda Ry, Rx, S: bench.make_inputs("cuda", Ry, Rx, S, 256))
    for case, ms in sched["ms"].items():
        bound = sched["bound_ms"][case]
        print(f"splat_sched {case} (bound {bound:.4f} ms):", flush=True)
        for k, v in ms.items():
            print(f"  {v:8.4f} ms  x{v / ms['index_add_']:5.2f} of "
                  f"index_add_  {100 * bound / v:5.1f} % of bound  {k}",
                  flush=True)
    print(f"splat_sched, max errors against plain: "
          f"{max(sched['err'].values()):.3g}", flush=True)
    walk = results["gather_tilewalk"] = time_tilewalk(libs)
    for case, ms in walk["ms"].items():
        bound = walk["bound_ms"][case]
        print(f"gather_tilewalk {case} (bound {bound:.4f} ms, "
              f"{walk['passes_per_block'][case]:.2f} passes per block):",
              flush=True)
        for k, v in ms.items():
            print(f"  {v:8.4f} ms  x{v / ms['torch indexing']:5.2f} of "
                  f"torch indexing  {100 * bound / v:5.1f} % of bound  {k}",
                  flush=True)
    print("gather_tilewalk: every version bitwise equal to plain, passes "
          "equal to the plain count", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
