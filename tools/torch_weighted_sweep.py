"""Time variants of the weighted crossproduct kernel (B9) side by side on one
GPU.

    python tools/torch_weighted_sweep.py [--rounds 2] [--source NAME=PATH]
        [--only NAME]

Each variant is ``miraculix_tpu_torch/csrc/crossprod_weighted.cu`` with some
of its text replaced: the kernel's geometry (warps a tile edge, words a
stage, stages, blocks an SM: the ``using Cfg = Shape<...>`` line) or a
diagnostic cut (the mmas, the copies, the decode and the digit products,
or all but the mmas left out); each ``--source`` is another tree's copy of
the file (headers beside it), with this kernel's C interface or with the
f32-FMA kernel's, which took no digit buffer.  Each is built with the
package's nvcc flags into a library of its own (one nvcc each, all started
together; a variant that does not build is reported and left out).  On
random genotype words at ``chip_smoke.py``'s shape (16,384 rows x 4,096
words, the upper triangle with its mirror) and GCTA-range weights (1 / (2pq
m), allele frequencies down to 1e-4), each library's whole launch (digit
pre-pass and product) is timed in turns by ``torch_int8_sweep.sweep``
(CUDA events; forward, then backward, ``--rounds`` times), and the median
of each is printed with its share of the bound (three bf16 passes over the
triangle at the bf16 peak), the kernel's registers, spill bytes and blocks
per SM, and its largest error against the float64 product per output's
sum of |terms| (the smoke's limit is 4e-6).  Diagnostic cuts compute
something else.  ``--only`` keeps the named variants (the committed kernel
is always timed).
"""
from __future__ import annotations

import ctypes
import os
import re
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_int8_sweep import PEAK_BF16, sweep, words  # noqa: E402

SOURCE = "crossprod_weighted.cu"
SHAPE = r"using Cfg = Shape<(\d+), (\d+), (\d+), (\d+)>;"
ROWS, KW = 16384, 4096
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def shape(text: str, **change) -> list:
    """The pattern that sets fields (edge, ks, stages, min_blocks) of the
    Cfg line of ``text``."""
    vals = dict(zip(("edge", "ks", "stages", "min_blocks"),
                    map(int, re.search(SHAPE, text).groups())))
    vals.update(change)
    return [(SHAPE, f"using Cfg = Shape<{vals['edge']}, {vals['ks']}, "
             f"{vals['stages']}, {vals['min_blocks']}>;")]


def variants(text: str) -> dict:
    """name -> [(pattern, replacement)], each of which must match."""
    copies = [(r"if \(s < nst\) load\(s\);", ";"),
              (r"if \(s \+ S::STAGES - 1 < nst\) load\([^;]*;", ";")]
    # the mmas cut: their operands XORed into the stage sums (kept live, so
    # that no decode becomes dead code)
    mma = [(r"if \(kk == 0\) mx::mma_bf16_zero\(d\[dd\]\[mi\]\[u\], a\[mi\], "
            r"bw\);\s*else mx::mma_bf16\(d\[dd\]\[mi\]\[u\], a\[mi\], bw\);",
            "{ const uint32_t x = a[mi][0] ^ a[mi][1] ^ a[mi][2] ^ a[mi][3] "
            "^ bw.x ^ bw.y; d[dd][mi][u][0] = __uint_as_float((kk == 0 ? 0u "
            ": __float_as_uint(d[dd][mi][u][0])) ^ x); }")]
    decode = [(r"(a\[mi\]\[\d\]) = mx::plane_pair_bf16\((x\d), \d\);",
               r"\1 = \2;"),
              (r"(b\[u\]\[\d\]) = mx::plane_pair_bf16\(y, (\d)\);",
               r"\1 = y + \2;"),
              (r"hmul2\((b\[u\]\[\d\]), (wd\[dd\]\.[xy])\)", r"(\1 ^ \2)")]
    loads = [(r"wa\[i\] = \*reinterpret_cast<const uint2\*>\([^;]*;",
              "wa[i] = make_uint2(lane ^ q, i + s);"),
             (r"wb\[u\] = \*reinterpret_cast<const uint2\*>\([^;]*;",
              "wb[u] = make_uint2(s ^ u, q + lane);"),
             (r"wd\[dd\] = ds\[[^;]*;", "wd[dd] = make_uint2(kk + dd, t);")]
    return {
        "committed": [],
        "one block an SM": shape(text, min_blocks=1),
        "three blocks an SM": shape(text, min_blocks=3),
        "2 stages": shape(text, stages=2),
        "3 stages": shape(text, stages=3),
        "16-word stages, 4 deep": shape(text, ks=16, stages=4),
        "64-word stages, 2 deep": shape(text, ks=64, stages=2),
        "32-row tiles (1 warp)": shape(text, edge=1, min_blocks=4),
        # diagnostics
        "cut: mma": mma,
        "cut: copies": copies,
        "cut: decode and digit products": decode,
        "cut: all but the mma": copies + decode + loads,
    }


def weighted_bench(built: dict, dev, rng) -> dict:
    """The whole launch of each library at the smoke's shape."""
    import numpy as np
    import torch
    from miraculix_tpu_torch.ops.common import decode_planar16

    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm",
            "tile", "threads", "words", "stages")
    libs, info = {}, {}
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        if hasattr(lib, "mx_weighted_digits_bytes"):
            lib.mx_weighted_digits_bytes.argtypes = [i32]
            lib.mx_weighted_digits_bytes.restype = i64
            lib.mx_weighted_info.argtypes = [ctypes.POINTER(i32)]
            lib.mx_crossprod_weighted.argtypes = [vp, i32, i32, vp, i32, vp,
                                                  vp, vp]
            vals = (ctypes.c_int * 8)(*([-1] * 8))
            lib.mx_weighted_info(vals)
            info[name] = str(dict(zip(keys, vals)))
        else:   # the f32-FMA kernel's interface
            lib.mx_crossprod_weighted.argtypes = [vp, i32, i32, vp, i32, vp,
                                                  vp]
            info[name] = "(the f32-FMA kernel)"
        libs[name] = lib
    zq = words(rng, ROWS, KW, dev)
    p = np.concatenate([rng.uniform(0.01, 0.5, 15 * KW),
                        10.0 ** rng.uniform(-4, -2, KW)])
    rng.shuffle(p)
    w64 = torch.as_tensor(1.0 / (2.0 * p * (1.0 - p) * 16 * KW),
                          dtype=torch.float64, device=dev)
    w = w64.float().reshape(16, KW).contiguous()
    d = decode_planar16(zq, torch.float64)
    want = (d * w.double().reshape(-1)) @ d.T   # every term >= 0: the scale
    del d
    torch.cuda.empty_cache()
    out = torch.empty((ROWS, ROWS), dtype=torch.float32, device=dev)
    stream = vp(torch.cuda.current_stream(dev).cuda_stream)
    dg = {}

    def launch(name, _):
        lib = libs[name]
        if not hasattr(lib, "mx_weighted_digits_bytes"):
            return lib.mx_crossprod_weighted(
                vp(zq.data_ptr()), ROWS, KW, vp(w.data_ptr()), 0,
                vp(out.data_ptr()), stream)
        if name not in dg:
            dg[name] = torch.empty(lib.mx_weighted_digits_bytes(KW),
                                   dtype=torch.uint8, device=dev)
        return lib.mx_crossprod_weighted(
            vp(zq.data_ptr()), ROWS, KW, vp(w.data_ptr()), 0,
            vp(dg[name].data_ptr()), vp(out.data_ptr()), stream)

    def error(_):
        return float(((out.double() - want).abs() / want.clamp_min(1e-300))
                     .max())

    # three bf16 passes over the upper triangle
    macs = 3 * ROWS * (ROWS + 1) / 2 * 16 * KW
    nbytes = 4 * (zq.numel() + 16 * KW + ROWS * ROWS)
    return {"launch": launch, "info": info, "error": error,
            "shapes": {f"{ROWS} x {KW} words, triangle": (macs, nbytes, 2)}}


if __name__ == "__main__":
    sys.exit(sweep({"weighted": (SOURCE, variants, weighted_bench,
                                 PEAK_BF16)}))
