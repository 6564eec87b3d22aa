"""Time variants of the int8 tensor-core kernels side by side on one GPU.

    python tools/torch_int8_sweep.py KERNEL [--rounds 2] [--source NAME=PATH]
        [--only NAME]

KERNEL is ``crossprod`` (K3, B8 and B12: ``csrc/crossprod.cu``) or
``matmul_int8`` (B10, the exact digit product: ``csrc/matmul_int8.cu``).
Each variant is the kernel's source in ``miraculix_tpu_torch/csrc`` with
some of its text replaced (a constant, an instance's geometry, the launch
bounds, or a diagnostic cut); each ``--source`` is another tree's copy of
the same file with the same C interface (with the headers beside it: a
parent tree unpacked by ``git archive``, say).  Each is built with the
package's nvcc flags into a library of its own (one nvcc each, all started
together; a variant that does not build is reported and left out).  On
random genotype words at ``chip_smoke.py``'s shapes the variants are timed
in turns (CUDA events; the order forward, then backward, ``--rounds``
times), and the median of each is printed with its rate, its share of the
shape's bound (int8 peak or memory rate, whichever is longer), the
registers, spill bytes and resident blocks per SM of its kernels, and
whether its results equal the committed kernel's on every shape
(diagnostic cuts compute something else and are expected to differ).
``--only`` keeps the named variants (the committed kernel is always timed).

Shapes: ``crossprod`` -- K3 at 16,384 rows x 4,096 words, B8 at the
``grm_blocked`` tile (8,192 x 8,192 x 4,096 words) and at the LD block
(4,096 x 4,608 x 1,024 words); the committed K3 is also held to its plain
version.  ``matmul_int8`` -- 'n' = 16,384 x 4,096 words and 't' = 65,536 x
1,024 words, each by 96 and by 8 digit columns (digits laid out once, the
launch alone timed, each variant under the package's split rule on its own
geometry; the committed kernel also under the rule for two waves); the
digit layout pre-pass is checked against its plain version and timed alone.
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

# H100 SXM data sheet: dense int8 and bf16 peaks, HBM3 rate
PEAK_INT8, PEAK_BF16, HBM_RATE = 1979e12, 989e12, 3.35e12
DIAGNOSTIC = "cut: "
vp, i32 = ctypes.c_void_p, ctypes.c_int

# name -> [(pattern, replacement)] applied to the source (each must match)
CROSSPROD = {
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
    "cut: mma": [(r"mx::mma_s8\(acc\[mi\]\[ni\], a\[mi\], b\[ni\]\);",
                  "acc[mi][ni][0] ^= a[mi][0] ^ b[ni][0];")],
    "cut: all but the mma": [
        (r"decode_stage\(r[^;]*;", ";"),
        (r'asm volatile\(\s*"ldmatrix.*?: "r"\(a\)\);',
         "r[0] = r[1] = r[2] = r[3] = a;")],
}

NARROW = r"using Narrow = Cfg<1, 1, 8, 1, 32, 4>;"
WIDE = r"using Wide = Cfg<12, 1, 8, 2, 32, 2>;"
MATMUL_INT8 = {
    "committed": [],
    "wide 16-word stages, 4 stages": [
        (WIDE, "using Wide = Cfg<12, 1, 8, 2, 16, 4>;")],
    "wide 64 x 48 a warp (8 warps, 2 across)": [
        (WIDE, "using Wide = Cfg<12, 2, 4, 4, 32, 2>;")],
    "wide 16 x 96 a warp (16 warps)": [
        (WIDE, "using Wide = Cfg<12, 1, 16, 1, 32, 2>;")],
    "wide 32 x 48 a warp (16 warps, 2 across)": [
        (WIDE, "using Wide = Cfg<12, 2, 8, 2, 32, 2>;")],
    "narrow 3 stages (3 blocks an SM)": [
        (NARROW, "using Narrow = Cfg<1, 1, 8, 1, 32, 3>;")],
    "narrow 256 rows, 3 stages": [
        (NARROW, "using Narrow = Cfg<1, 1, 8, 2, 32, 3>;")],
    # diagnostics: the mmas cut (their fragments XORed into acc); the
    # global -> shared copies cut (stages hold what they held); everything
    # but the mmas cut (no copies, fragments from their lane's indices
    # instead of shared loads and shifts): the mma.sync pipe's own time
    "cut: mma": [(r"mx::mma_s8\(acc\[mi\]\[ni\], af, bf\);",
                  "acc[mi][ni][0] ^= af[0] ^ bf[0];")],
    "cut: copies": [(r"\bload\(s[^;]*\);", ";")],
    "cut: all but the mma": [
        (r"\bload\(s[^;]*\);", ";"),
        (r"lo\[mi\] = \*reinterpret_cast<const uint4\*>\([^;]*;",
         "lo[mi] = make_uint4(r, p, r ^ p, r + p);"),
        (r"hi\[mi\] = \*reinterpret_cast<const uint4\*>\([^;]*;",
         "hi[mi] = make_uint4(p, r, r + p, r ^ p);"),
        (r"bq\[ni\] = \*reinterpret_cast<const uint4\*>\([^;]*;",
         "bq[ni] = make_uint4(ni, g, t, p);"),
        (r"\(el\((lo|hi)\[mi\], (2 \* h(?: \+ 1)?)\) >> sh\) & 0x03030303u",
         r"el(\1[mi], \2)")],
}
# B10's committed kernel again under another split rule: name -> waves
B10_WAVES = {"committed, splits for 2 waves": 2}


def build(csrc: Path, source: str, variants: dict, sources: dict, out: Path,
          nvcc: str, flags, only=()) -> dict:
    """One library per variant (those in ``only`` and the committed one,
    where ``only`` is given) and per other source, compiled in parallel ->
    name -> path.  The committed kernel must build."""
    jobs = {}
    todo = [(name, csrc, subs) for name, subs in variants.items()
            if not only or name in only or name == "committed"]
    todo += [(name, Path(src).parent, []) for name, src in sources.items()]
    for i, (name, src_dir, subs) in enumerate(todo):
        d = out / f"v{i}"
        d.mkdir()
        for header in src_dir.glob("*.cuh"):
            shutil.copy(header, d)
        text = (src_dir / source).read_text()
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text, flags=re.S)
            if n == 0:
                raise RuntimeError(f"variant {name!r}: {pat!r} matches "
                                   "nothing")
        (d / source).write_text(text)
        lib = d / "lib.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-shared", str(d / source), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode and name == "committed":
            raise RuntimeError(f"the committed kernel: nvcc failed\n{log}")
        if proc.returncode:
            print(f"variant {name!r}: nvcc failed, left out\n{log[-2000:]}",
                  flush=True)
        else:
            built[name] = lib
    return built


def event_ms(fn, reps=10):
    """Mean time of ``reps`` calls of ``fn`` (a launch returning its error
    code) in one stretch of CUDA events, after one checked call."""
    import torch

    if fn():
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def words(rng, rows, kw, dev):
    """Random planar16 words whose 2-bit fields are 0, 1 or 2."""
    import numpy as np
    import torch

    w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
    w = w.astype(np.uint32)
    both = (w & (w >> np.uint32(1))) & np.uint32(0x55555555)
    w &= ~(both << np.uint32(1))
    return torch.from_numpy(w.view(np.int32)).to(dev)


def crossprod_bench(built: dict, dev, rng) -> dict:
    """K3 and B8's launches at the smoke's shapes, for each library."""
    import torch
    from miraculix_tpu_torch.ops.grm import packed_crossprod_plain

    libs, info = {}, {}
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        lib.mx_crossprod.argtypes = [vp, i32, i32, vp, vp]
        lib.mx_crossprod_rect.argtypes = [vp, i32, vp, i32, i32, i32, vp, vp]
        vals = (ctypes.c_int * 4)(-1, -1, -1, -1)
        if hasattr(lib, "mx_crossprod_info"):   # not in older trees
            lib.mx_crossprod_info.argtypes = [i32, ctypes.POINTER(i32)]
            if lib.mx_crossprod_info(0, vals):
                raise RuntimeError(f"{name!r}: no kernel attributes")
        libs[name] = lib
        info[name] = (f"{vals[0]} registers, {vals[1]} spill bytes, "
                      f"{vals[3]} blocks an SM")
    zn, zt = words(rng, 16384, 4096, dev), words(rng, 4608, 1024, dev)
    za, zb = zn[:8192], zn[8192:]
    out = {"K3": torch.empty((16384, 16384), dtype=torch.int32, device=dev),
           "B8 tile": torch.empty((8192, 8192), dtype=torch.int32,
                                  device=dev),
           "B8 LD": torch.empty((4096, 4608), dtype=torch.int32, device=dev)}
    stream = vp(torch.cuda.current_stream(dev).cuda_stream)
    p = vp
    calls = {
        "K3": lambda lib: lib.mx_crossprod(
            p(zn.data_ptr()), 16384, 4096, p(out["K3"].data_ptr()), stream),
        "B8 tile": lambda lib: lib.mx_crossprod_rect(
            p(za.data_ptr()), 8192, p(zb.data_ptr()), 8192, 4096, 0,
            p(out["B8 tile"].data_ptr()), stream),
        "B8 LD": lambda lib: lib.mx_crossprod_rect(
            p(zt.data_ptr()), 4096, p(zt.data_ptr()), 4608, 1024, 0,
            p(out["B8 LD"].data_ptr()), stream),
    }
    shapes = {   # name -> (multiply-adds, bytes moved, reps)
        "K3": (16384 * 16385 / 2 * 65536,
               4 * (zn.numel() + out["K3"].numel()), 3),
        "B8 tile": (8192 * 8192 * 65536,
                    4 * (zn.numel() + out["B8 tile"].numel()), 3),
        "B8 LD": (4096 * 4608 * 16384,
                  4 * (zt.numel() + out["B8 LD"].numel()), 10),
    }
    calls["K3"](libs["committed"])
    torch.cuda.synchronize()
    note = (f"committed K3 equals plain: "
            f"{bool(torch.equal(out['K3'], packed_crossprod_plain(zn)))}")
    return {"launch": lambda name, s: calls[s](libs[name]), "shapes": shapes,
            "out": out, "info": info, "notes": lambda: [note]}


def matmul_int8_bench(built: dict, dev, rng) -> dict:
    """B10's launches at the smoke's four shapes, for each library (and the
    committed one under the split rules of ``B10_WAVES``)."""
    import torch
    from miraculix_tpu_torch import _kernels

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm",
            "rows", "cols", "words", "threads")
    libs, geometry, info = {}, {}, {}
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        lib.mx_matmul_int8_info.argtypes = [i32, ctypes.POINTER(i32)]
        lib.mx_matmul_int8.argtypes = [vp, i32, i32, vp, i32, i32, i32, vp,
                                       vp]
        lib.mx_matmul_int8_layout.argtypes = [vp, i32, i32, i32, vp, vp]
        geometry[name] = {}
        for wide, inst in enumerate(_kernels.INT8_INSTANCES):
            vals = (ctypes.c_int * 8)()
            if lib.mx_matmul_int8_info(wide, vals):
                raise RuntimeError(f"{name!r}: no kernel attributes")
            geometry[name][inst] = dict(zip(keys, vals))
        libs[name] = lib
    for name in B10_WAVES:
        libs[name], geometry[name] = libs["committed"], geometry["committed"]
    for name, g in geometry.items():
        info[name] = "; ".join(
            f"{k} {v['registers']} registers {v['local_bytes']} spill bytes "
            f"{v['blocks_per_sm']} blocks an SM" for k, v in g.items())

    stream = vp(torch.cuda.current_stream(dev).cuda_stream)
    p = vp
    layout = libs["committed"].mx_matmul_int8_layout
    panels = {"n": words(rng, 16384, 4096, dev),
              "t": words(rng, 65536, 1024, dev)}
    operands, shapes, out, layouts = {}, {}, {}, {}
    for label, zq in panels.items():
        rows, kw = zq.shape
        for n in (96, 8):
            s = f"{label} {n}"
            d = torch.as_tensor(rng.integers(-64, 65, size=(16 * kw, n)),
                                dtype=torch.int8, device=dev)
            dq = torch.empty((n, -(-kw // 4), 4, 4), dtype=torch.int32,
                             device=dev)
            layouts[s] = (lambda d=d, kw=kw, dq=dq: layout(
                p(d.data_ptr()), d.shape[0], d.shape[1], kw, p(dq.data_ptr()),
                stream))
            layouts[s]()
            torch.cuda.synchronize()
            if not torch.equal(dq.cpu(), _kernels.digit_quads(d.cpu(), kw)):
                raise RuntimeError("the layout pre-pass differs from its "
                                   "plain version")
            out[s] = torch.empty((rows, n), dtype=torch.int32, device=dev)
            operands[s] = (zq, dq, n, "narrow" if n <= 8 else "wide")
            shapes[s] = (rows * 16 * kw * n,
                         4 * zq.numel() + d.numel() + 4 * rows * n, 10)

    def launch(name, s):
        zq, dq, n, inst = operands[s]
        rows, kw = zq.shape
        per = _kernels.int8_split_words(rows, kw, n, geometry[name][inst], sms,
                                        waves=B10_WAVES.get(name, 1))
        return libs[name].mx_matmul_int8(
            p(zq.data_ptr()), rows, kw, p(dq.data_ptr()), n,
            _kernels.INT8_INSTANCES.index(inst), per, p(out[s].data_ptr()),
            stream)

    def notes():
        return ["digit layout pre-pass alone: " + "; ".join(
            f"{s} {statistics.median(event_ms(fn) for _ in range(3)):.4f} ms"
            for s, fn in layouts.items())]

    return {"launch": launch, "shapes": shapes, "out": out, "info": info,
            "notes": notes}


KERNELS = {   # name -> (source file, variants, bench, peak op/s)
    "crossprod": ("crossprod.cu", CROSSPROD, crossprod_bench, PEAK_INT8),
    "matmul_int8": ("matmul_int8.cu", MATMUL_INT8, matmul_int8_bench,
                    PEAK_INT8),
}


def sweep(kernels: dict) -> int:
    """The command line of a sweep over ``kernels`` (name -> (source file,
    variants: a dict, or a function of the source text returning one,
    bench, the peak op/s of its bound); KERNEL is asked for where there
    are several): build the variants, time them in turns and print the
    report.  A bench returns ``launch(name, shape)`` (a launch returning
    its error code), ``shapes`` (shape -> (multiply-adds, bytes moved,
    reps)), ``info`` (variant -> its kernels' attributes) and either
    ``out`` (shape -> the output tensor, held bit for bit to the committed
    kernel's) or ``error(shape)`` (the last launch's error), and may
    return ``notes()`` (lines printed last)."""
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    if len(kernels) > 1:
        ap.add_argument("kernel", choices=list(kernels))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="also time this copy of the "
                    "kernel's source (another tree's, headers beside it)")
    ap.add_argument("--only", action="append", default=[], metavar="NAME",
                    help="time only this variant (repeatable; the committed "
                    "kernel is always timed)")
    args = ap.parse_args()
    kernel = args.kernel if len(kernels) > 1 else next(iter(kernels))
    source, variants, bench, peak = kernels[kernel]
    from miraculix_tpu_torch import _kernels

    if callable(variants):
        variants = variants((_kernels._CSRC / source).read_text())
    unknown = set(args.only) - set(variants)
    if unknown:
        ap.error(f"no {kernel} variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print(f"{ap.prog}: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = dict(a.split("=", 1) for a in args.source)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        built = build(_kernels._CSRC, source, variants, sources, Path(tmp),
                      _kernels._nvcc(), _kernels.NVCC_FLAGS, args.only)
        b = bench(built, dev, np.random.default_rng(0))
        launch, shapes = b["launch"], b["shapes"]
        names = list(b["info"])
        equal = dict.fromkeys(names, True)
        err = {n: {} for n in names}
        for s in shapes:
            want = None
            for name in ["committed"] + [n for n in names
                                         if n != "committed"]:
                if launch(name, s):
                    raise RuntimeError(f"{name!r} {s}: launch failed")
                torch.cuda.synchronize()
                if "error" in b:
                    err[name][s] = b["error"](s)
                elif want is None:
                    want = b["out"][s].clone()
                else:
                    equal[name] &= bool(torch.equal(b["out"][s], want))
            del want
        times = {(n, s): [] for n in names for s in shapes}
        for _ in range(args.rounds):
            for order in (names, names[::-1]):
                for name in order:
                    for s, (_, _, reps) in shapes.items():
                        times[(name, s)].append(event_ms(
                            lambda: launch(name, s), reps))
        for name in names:
            cells = []
            for s, (macs, nbytes, _) in shapes.items():
                ms = statistics.median(times[(name, s)])
                bms = 1e3 * max(2 * macs / peak, nbytes / HBM_RATE)
                cells.append(f"{s} {ms:.4f} ms ({2e-9 * macs / ms:.1f} T "
                             f"op/s, {100 * bms / ms:.1f}% of its bound "
                             f"{bms:.4f} ms" + (f", err {err[name][s]:.3g})"
                                                if "error" in b else ")"))
            tag = " (diagnostic)" if name.startswith(DIAGNOSTIC) else ""
            print(f"{name}{tag}: {'; '.join(cells)}; {b['info'][name]}"
                  + ("" if "error" in b else f"; equal {equal[name]}"),
                  flush=True)
        for line in b.get("notes", list)():
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(sweep(KERNELS))
