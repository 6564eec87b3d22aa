"""Time variants of the wide dgemm kernel (B3, B4, B5, B11) side by side on
one GPU.

    python tools/torch_wide_sweep.py [--rounds 2] [--source NAME=PATH]
        [--only NAME]

Each variant is ``miraculix_tpu_torch/csrc/wide_dgemm.cu`` with some of its
text replaced: the instances' geometry (rows a block, chunk width, stage
words and depth, words a promotion: the ``using One/Two/Three = Shape<...>``
lines) or a diagnostic cut (the mmas, the copies, the decode, all but the
mmas, the pre-pass or the main kernel left out); each ``--source`` is
another tree's copy of the file with the same C interface (headers beside
it).  Each is built with the package's nvcc flags into a library of its own
(one nvcc each, all started together; a variant that does not build is
reported and left out).  On random genotype words at ``chip_smoke.py``'s
shapes ('n' = 16,384 x 4,096 words, 't' = 65,536 x 1,024) and the smoke's
wide widths, each library's whole launch (pre-pass, mma kernel, split
reduction, under the package's split rule on the variant's own geometry)
is timed in turns (CUDA events; forward, then backward, ``--rounds``
times), and the median of each is printed with its share of the bound (the
tier's bf16 passes at the bf16 peak), its instances' registers, spill bytes
and blocks per SM, and its largest error against the float64 product of
the instance's parts per output's sum of |terms| (the smoke's limit is
4e-6; two shapes take a positive, lo-biased B whose sums grow without
cancelling).  Diagnostic cuts compute something else.  ``--only`` keeps the
named variants (the committed kernel is always timed).
"""
from __future__ import annotations

import ctypes
import os
import re
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_int8_sweep import PEAK_BF16, sweep, words  # noqa: E402

SOURCE = "wide_dgemm.cu"
SHAPE = r"using {} = Shape<(\d+), (\d+), (\d+), (\d+), (\d+)>;"
NAMES = ("One", "Two", "Three")          # one, two, three bf16 parts
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def shapes(text: str, **change) -> list:
    """Patterns that set fields (mi, nt_max, ks, stages, promote) of the
    Shape lines of ``text``; ``parts`` limits them to those part counts."""
    parts = change.pop("parts", (1, 2, 3))
    subs = []
    for p, name in enumerate(NAMES, 1):
        if p not in parts:
            continue
        m = re.search(SHAPE.format(name), text)
        vals = dict(zip(("mi", "nt_max", "ks", "stages", "promote"),
                        map(int, m.groups())))
        vals.update(change)
        subs.append((SHAPE.format(name),
                     f"using {name} = Shape<{vals['mi']}, {vals['nt_max']}, "
                     f"{vals['ks']}, {vals['stages']}, {vals['promote']}>;"))
    return subs


def variants(text: str) -> dict:
    """name -> [(pattern, replacement)], each of which must match."""
    copies = [(r"if \(s < nst\) load\(s\);", ";"),
              (r"if \(s \+ C::STAGES - 1 < nst\) load\([^;]*;", ";")]
    mma = (r"if \(kk % PROMOTE == 0\)\s*mx::mma_bf16_zero\(d\[p\]\[mi\]\[u\], "
           r"a\[mi\], bb\);\s*else\s*mx::mma_bf16\(d\[p\]\[mi\]\[u\], "
           r"a\[mi\], bb\);")
    decode = (r"a\[mi\]\[(\d)\] = mx::plane_pair_bf16\((x\d), \d\);",
              r"a[mi][\1] = \2;")
    return {
        "committed": [],
        "128-row blocks": shapes(text, mi=1),
        "promote every word": shapes(text, promote=1),
        "promote every 4 words": shapes(text, promote=4),
        "promote every 16 words": shapes(text, promote=16),
        "16-word stages, 3 deep": shapes(text, ks=16, stages=3, promote=16),
        "8-word stages, 4 deep": shapes(text, ks=8, stages=4, promote=8),
        "one pass in chunks of 32": shapes(text, nt_max=4, parts=(1,)),
        "two passes in chunks of 24": shapes(text, nt_max=3, parts=(2,)),
        "two passes in chunks of 64, 16-word stages":
            shapes(text, nt_max=8, ks=16, stages=2, promote=16, parts=(2,)),
        "three passes in chunks of 32, 16-word stages, 3 deep":
            shapes(text, nt_max=4, ks=16, stages=3, promote=16, parts=(3,)),
        "three passes in 128-row blocks": shapes(text, mi=1, parts=(3,)),
        # diagnostics
        "cut: mma": [(mma, "d[p][mi][u][0] = d[p][mi][u][1] = d[p][mi][u][2]"
                      " = d[p][mi][u][3] = __uint_as_float(a[mi][0] ^ "
                      "a[mi][1] ^ a[mi][2] ^ a[mi][3] ^ bb.x ^ bb.y);")],
        "cut: copies": copies,
        "cut: decode ALU": [decode],
        "cut: all but the mma": copies + [
            decode,
            (r"lo\[mi\] = \*reinterpret_cast<const uint2\*>\([^;]*;",
             "lo[mi] = make_uint2(lane ^ q, mi + s);"),
            (r"hi\[mi\] = \*reinterpret_cast<const uint2\*>\([^;]*;",
             "hi[mi] = make_uint2(s ^ mi, q + lane);"),
            (r"const uint2 bb = ps\[[^;]*;",
             "const uint2 bb = make_uint2(lane + u, p + kk);")],
        "cut: main kernel (pre-pass and reduction alone)": [
            (r"const int err = dispatch_passes\(passes, nt, &a, nullptr\);",
             "const int err = 0;")],
        "cut: pre-pass": [(r"wide_parts<<<[^;]*;", ";")],
    }


# (rhs, orientation, columns, positive B): the smoke's wide cases
CASES = [("split", "n", 65, False), ("split", "n", 128, False),
         ("split", "n", 600, False), ("f32", "n", 130, False),
         ("f32", "n", 65, False), ("bf16", "n", 130, False),
         ("bf16", "n", 65, False), ("hilo", "n", 32, False),
         ("split", "t", 65, False), ("f32", "t", 130, False),
         ("bf16", "t", 130, False), ("split", "n", 65, True),
         ("f32", "n", 130, True)]


def wide_bench(built: dict, dev, rng) -> dict:
    """The whole launch of each library at the smoke's wide shapes."""
    import torch
    from miraculix_tpu_torch import _kernels
    from miraculix_tpu_torch.ops.common import decode_planar16
    from miraculix_tpu_torch.ops.dgemm import rhs_values

    from chip_smoke import lo_biased

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm",
            "rows", "cols", "words", "threads", "promote", "stages")
    libs, info, inst = {}, {}, {}
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        lib.mx_wide_tiles.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.mx_wide_info.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.mx_wide_parts_bytes.argtypes = [i32, i32, i32]
        lib.mx_wide_parts_bytes.restype = i64
        lib.mx_wide_dgemm.argtypes = [vp, i32, i32, vp, i64, i32, i32, vp,
                                      i32, vp, vp, vp]
        geometry = {}
        for rhs, _, n, _ in CASES:
            passes = _kernels.WIDE_PASSES[rhs]
            t = (ctypes.c_int * 3)()
            vals = (ctypes.c_int * 10)()
            if lib.mx_wide_tiles(n, passes, t) \
                    or lib.mx_wide_info(passes, t[1], vals) or vals[3] < 1:
                break
            geometry[(passes, t[1])] = dict(zip(keys, vals))
        else:
            libs[name], inst[name] = lib, geometry
            continue
        print(f"variant {name!r}: an instance does not fit an SM, left out",
              flush=True)
    for name in inst:
        info[name] = "; ".join(
            f"{p}x{nt} {v['registers']} registers {v['local_bytes']} spill "
            f"bytes {v['blocks_per_sm']} blocks an SM"
            for (p, nt), v in sorted(inst[name].items()))
    if "committed" not in libs:
        raise RuntimeError("the committed kernel fits no block on an SM")

    stream = vp(torch.cuda.current_stream(dev).cuda_stream)
    panels = {"n": words(rng, 16384, 4096, dev),
              "t": words(rng, 65536, 1024, dev)}
    operands, shapes_, out, want, scale, bufs = {}, {}, {}, {}, {}, {}
    for label, zq in panels.items():
        rows, kw = zq.shape
        d64 = decode_planar16(zq, torch.float64)
        for rhs, tr, n, positive in CASES:
            if tr != label:
                continue
            s = f"{rhs} {tr} {n}" + (" positive" if positive else "")
            b = torch.as_tensor(rng.standard_normal((16 * kw, n)),
                                dtype=torch.float32, device=dev)
            if positive:
                b = lo_biased(b.abs())
            bh = rhs_values(b, rhs).double()
            want[s], scale[s] = d64 @ bh, d64 @ bh.abs()
            out[s] = torch.empty((rows, n), dtype=torch.float32, device=dev)
            operands[s] = (zq, b, _kernels.WIDE_PASSES[rhs])
            passes = _kernels.WIDE_PASSES[rhs]
            shapes_[s] = (rows * 16 * kw * n * passes,
                          4 * zq.numel() + 4 * b.numel() + 4 * rows * n,
                          3 if n > 128 else 10)
        del d64
        torch.cuda.empty_cache()

    def launch(name, s):
        zq, b, passes = operands[s]
        rows, kw = zq.shape
        n = b.shape[1]
        lib = libs[name]
        if (name, s) not in bufs:
            t = (ctypes.c_int * 3)()
            lib.mx_wide_tiles(n, passes, t)
            per = _kernels.wide_split_words(rows, kw, n,
                                            inst[name][(passes, t[1])], sms)
            splits = -(-kw // per)
            parts = torch.empty(lib.mx_wide_parts_bytes(kw, n, passes),
                                dtype=torch.uint8, device=dev)
            work = torch.empty((splits, rows, n), dtype=torch.float32,
                               device=dev) if splits > 1 else None
            bufs[(name, s)] = (per, parts, work)
        per, parts, work = bufs[(name, s)]
        return lib.mx_wide_dgemm(
            vp(zq.data_ptr()), rows, kw, vp(b.data_ptr()), b.shape[0], n,
            passes, vp(parts.data_ptr()), per, vp(out[s].data_ptr()),
            vp(None if work is None else work.data_ptr()), stream)

    def error(s):
        return float(((out[s].double() - want[s]).abs()
                      / scale[s].clamp_min(1e-300)).max())

    return {"launch": launch, "shapes": shapes_, "info": info,
            "error": error}


if __name__ == "__main__":
    sys.exit(sweep({"wide": (SOURCE, variants, wide_bench, PEAK_BF16)}))
