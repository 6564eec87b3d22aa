"""Time variants of the integer crossproduct kernel side by side on one GPU.

    python tools/torch_crossprod_sweep.py [--rounds 2] [--source NAME=PATH]

Each variant is ``miraculix_tpu_torch/csrc/crossprod.cu`` with some of its
text replaced (a constant, the launch bounds, or a diagnostic cut); each
``--source`` is another tree's ``crossprod.cu`` (with the ``decode.cuh``
beside it: a parent tree unpacked by ``git archive``, say).  Each is built
with the package's nvcc flags into a library of its own (one nvcc each, all
started together).  On random genotype words at
``chip_smoke.py``'s shapes -- K3 at 16,384 rows x 4,096 words, B8 at the
``grm_blocked`` tile (8,192 x 8,192 x 4,096 words) and at the LD block
(4,096 x 4,608 x 1,024 words) -- the variants are timed in turns (CUDA
events; the order forward, then backward, ``--rounds`` times) and the
median of each is printed with its rate, registers, resident blocks per SM
and whether its K3 equals the committed kernel's (diagnostic cuts compute
something else and are expected to differ).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> [(pattern, replacement)] applied to crossprod.cu (each must match)
VARIANTS = {
    "committed": [],
    "stages 3": [(r"STAGES = 4;", "STAGES = 3;")],
    "stages 5": [(r"STAGES = 4;", "STAGES = 5;")],
    "group 1 (row-major walks)": [(r"GROUP = 8;", "GROUP = 1;")],
    "one block an SM": [(r"__launch_bounds__\(THREADS, 2\)",
                         "__launch_bounds__(THREADS, 1)")],
    # diagnostics: the decode's shift/mask work cut (raw words stored as
    # they are); the mmas cut (their fragments XORed into acc); everything
    # but the mmas cut (no decode, fragments made from their addresses
    # instead of ldmatrix): the mma.sync pipe's own time
    "cut: decode ALU": [(r"mx::int8_quads\(w\[i\]\)",
                         "make_uint4(w[i], w[i], w[i], w[i])")],
    "cut: mma": [(r"mma_s8\(acc\[mi\]\[ni\], a\[mi\], b\[ni\]\);",
                  "acc[mi][ni][0] ^= a[mi][0] ^ b[ni][0];")],
    "cut: all but the mma": [
        (r"decode_stage\(r[^;]*;", ";"),
        (r'asm volatile\(\s*"ldmatrix.*?: "r"\(a\)\);',
         "r[0] = r[1] = r[2] = r[3] = a;")],
}
DIAGNOSTIC = ("cut: ",)


def build(csrc: Path, sources: dict, out: Path, nvcc: str, flags) -> dict:
    """One library per variant and per other source (a crossprod.cu with
    its decode.cuh beside it), compiled in parallel -> name -> path."""
    jobs = {}
    todo = [(name, csrc, subs) for name, subs in VARIANTS.items()]
    todo += [(name, Path(src).parent, []) for name, src in sources.items()]
    for i, (name, src_dir, subs) in enumerate(todo):
        d = out / f"v{i}"
        d.mkdir()
        shutil.copy(src_dir / "decode.cuh", d)
        text = (src_dir / "crossprod.cu").read_text()
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text, flags=re.S)
            if n == 0:
                raise RuntimeError(f"variant {name!r}: {pat!r} matches "
                                   "nothing")
        (d / "crossprod.cu").write_text(text)
        lib = d / "lib.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-shared", str(d / "crossprod.cu"), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
    return {name: lib for name, (lib, _) in jobs.items()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_crossprod_sweep: no CUDA device", file=sys.stderr)
        return 2
    from miraculix_tpu_torch import _kernels
    from miraculix_tpu_torch.ops.grm import packed_crossprod_plain

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="also time this crossprod.cu "
                    "(another tree's, with the decode.cuh beside it)")
    args = ap.parse_args()
    rounds = args.rounds
    sources = dict(a.split("=", 1) for a in args.source)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        built = build(_kernels._CSRC, sources, Path(tmp), _kernels._nvcc(),
                      _kernels.NVCC_FLAGS)
        libs = {}
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for name, path in built.items():
            lib = ctypes.CDLL(str(path))
            lib.mx_crossprod.argtypes = [vp, i32, i32, vp, vp]
            lib.mx_crossprod_rect.argtypes = [vp, i32, vp, i32, i32, i32, vp,
                                              vp]
            info = (ctypes.c_int * 4)(-1, -1, -1, -1)
            if hasattr(lib, "mx_crossprod_info"):   # not in older trees
                lib.mx_crossprod_info.argtypes = [i32, ctypes.POINTER(i32)]
                if lib.mx_crossprod_info(0, info):
                    raise RuntimeError(f"{name!r}: no kernel attributes")
            libs[name] = (lib, tuple(info))

        rng = np.random.default_rng(0)

        def words(rows, kw):
            w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
            w = w.astype(np.uint32)
            both = (w & (w >> np.uint32(1))) & np.uint32(0x55555555)
            w &= ~(both << np.uint32(1))
            return torch.from_numpy(w.view(np.int32)).to(dev)

        zn, zt = words(16384, 4096), words(4608, 1024)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        p = ctypes.c_void_p
        out_sq = torch.empty((16384, 16384), dtype=torch.int32, device=dev)
        out_t = torch.empty((8192, 8192), dtype=torch.int32, device=dev)
        out_ld = torch.empty((4096, 4608), dtype=torch.int32, device=dev)
        za, zb = zn[:8192], zn[8192:]
        shapes = {  # name -> (launch(lib), multiply-adds, reps)
            "K3": (lambda lib: lib.mx_crossprod(
                p(zn.data_ptr()), 16384, 4096, p(out_sq.data_ptr()), stream),
                16384 * 16385 / 2 * 65536, 3),
            "B8 tile": (lambda lib: lib.mx_crossprod_rect(
                p(za.data_ptr()), 8192, p(zb.data_ptr()), 8192, 4096, 0,
                p(out_t.data_ptr()), stream), 8192 * 8192 * 65536, 3),
            "B8 LD": (lambda lib: lib.mx_crossprod_rect(
                p(zt.data_ptr()), 4096, p(zt.data_ptr()), 4608, 1024, 0,
                p(out_ld.data_ptr()), stream), 4096 * 4608 * 16384, 10),
        }

        def run(lib, launch, reps):
            if launch(lib):
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                launch(lib)
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / reps

        committed = libs["committed"][0]
        shapes["K3"][0](committed)
        torch.cuda.synchronize()
        want = out_sq.clone()
        print(f"committed K3 equals plain: "
              f"{bool(torch.equal(want, packed_crossprod_plain(zn)))}",
              flush=True)
        equal = {}
        for name, (lib, _) in libs.items():
            shapes["K3"][0](lib)
            torch.cuda.synchronize()
            equal[name] = bool(torch.equal(out_sq, want))
        times = {(n, s): [] for n in libs for s in shapes}
        order = list(libs)
        for _ in range(rounds):
            for names in (order, order[::-1]):
                for name in names:
                    for s, (launch, _, reps) in shapes.items():
                        times[(name, s)].append(run(libs[name][0], launch,
                                                    reps))
        for name, (_, info) in libs.items():
            cells = []
            for s, (_, macs, _) in shapes.items():
                ms = statistics.median(times[(name, s)])
                cells.append(f"{s} {ms:.4f} ms "
                             f"({2e-9 * macs / ms:.1f} T op/s)")
            tag = " (diagnostic)" if name.startswith(DIAGNOSTIC) else ""
            print(f"{name}{tag}: {'; '.join(cells)}; {info[0]} registers, "
                  f"{info[1]} spill bytes, {info[3]} blocks an SM; K3 equal "
                  f"{equal[name]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
