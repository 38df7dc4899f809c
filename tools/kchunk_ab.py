#!/usr/bin/env python3
"""A/B of builds of ``nnaudio_tpu_torch/csrc/framed_kchunk.cu`` (K6) on one
NVIDIA GPU.

    python3 tools/kchunk_ab.py

Builds the package's source as it is and changed by text: bin groups of 16
and of 8 in place of 32 (``GROUP``), and three diagnostic builds that each
leave one part out (the products, the frame tiles' copies, the bank tiles'
copies) and so compute garbage: the time that remains is the other parts'.
A ``--source`` file (another version of the kernel with the same entry
points, say from an older commit) is built and timed too. Times K6 at path
(g)'s shape (the default CQT1992v2 bank, 84 x 16384, hop 512, T=431; B=32
and B=1) and on CQT1992's dense composed bank of the same shape (B=32),
beside K1 on the same inputs, in fp32 and bf16 storage, with CUDA events,
in turns (the builds in order, then in reverse); every output of a build
that is not diagnostic is held against the committed build's (1e-4 /
5e-2). Then the committed build's device time by kernel (pre-pass, main
loop, second pass) for one call of each case under ``torch.profiler``.
Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from framed_tc_ab import compile_all  # noqa: E402
from nnaudio_tpu_torch import config  # noqa: E402
from nnaudio_tpu_torch.features import CQT1992, CQT1992v2  # noqa: E402
from nnaudio_tpu_torch.ops import build, framed_kernels as fk  # noqa: E402

GROUP = "constexpr int GROUP = 32;"
PRODUCT = "    consume_chunk<CAP>("
FRAMES = "      if (vb_x == 16) copy_frames<S, 16>("
BANK = "          if ((m >> g) & 1u) copy_group<S, CAP>("
BANK_BYTES = "        const uint32_t bytes = Kc<S>::PLANES * __popc(m) * TILE_BYTES_G;"
DIAGNOSTIC = ("no products", "no frame copies", "no bank copies")


def variants(src: str) -> dict[str, str]:
    for text in (GROUP, PRODUCT, FRAMES, BANK, BANK_BYTES):
        if src.count(text) != 1:
            raise SystemExit(f"framed_kchunk.cu: {text!r} is not where this tool expects it")
    return {"committed": src,
            "GROUP 16": src.replace(GROUP, "constexpr int GROUP = 16;"),
            "GROUP 8": src.replace(GROUP, "constexpr int GROUP = 8;"),
            "no products": src.replace(PRODUCT, "    if (0) consume_chunk<CAP>("),
            # the (g) signal is 16-byte aligned: its frames take the first branch
            "no frame copies": src.replace(FRAMES, "      if (0) copy_frames<S, 16>("),
            "no bank copies": src.replace(BANK, "          if (0) copy_group<S, CAP>(").replace(
                BANK_BYTES, "        const uint32_t bytes = 0;")}


def use(lib: ctypes.CDLL) -> None:
    fk._fns.clear()
    for fn, (lib_name, argtypes) in fk._SIGNATURES.items():
        if lib_name == "framed_kchunk":
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            fk._fns[fn] = f


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", default=[],
                        help="another framed_kchunk.cu (same entry points) to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kchunk_ab: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {cs.smi()}")
    build.build_all()  # K1's library
    src = (build.CSRC / "framed_kchunk.cu").read_text()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    banded = CQT1992v2(verbose=False, device=dev)
    dense = CQT1992(fmin=32.7, device=dev)
    n = banded.kernel_width
    x32 = torch.randn(32, 22050 * 10 + n, generator=gen, device=dev)
    x1 = x32[:1].contiguous()
    cases = {"(g) B=32": (x32, banded.cqt_kernels_real, banded.cqt_kernels_imag),
             "(g) B=1": (x1, banded.cqt_kernels_real, banded.cqt_kernels_imag),
             "CQT1992 dense B=32": (x32, dense.combined_real, dense.combined_imag)}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {**variants(src),
                  **{f"--source {Path(p).name}": Path(p).read_text() for p in args.source}}
        libs = {name: ctypes.CDLL(str(lib))
                for name, lib in compile_all(builds, Path(tmp)).items()}
        order = list(libs) + list(reversed(libs))
        for mode in ("highest", "default"):
            config.set_matmul_precision(mode)
            k1 = {case: cs.cuda_ms(lambda a=args: fk.framed_magnitude(*a, 512), queue_ahead=True)
                  for case, args in cases.items()}
            print(f"[time] {mode:8s} K1          " + ", ".join(
                f"{case} {ms:.3f} ms" for case, ms in k1.items()), flush=True)
            ref = {}
            for name in order:
                use(libs[name])
                row = []
                for case, args in cases.items():
                    def fn(a=args):
                        return fk.framed_magnitude_kchunk(*a, 512)
                    out = fn()
                    torch.cuda.synchronize()
                    if case not in ref:
                        ref[case] = out.clone()
                    elif name not in DIAGNOSTIC and cs.rel_err(out, ref[case]) > cs.TOL[mode]:
                        raise SystemExit(f"{name} {case} {mode}: output differs from the "
                                         "committed build's")
                    row.append(f"{case} {cs.cuda_ms(fn, queue_ahead=True):.3f} ms")
                print(f"[time] {mode:8s} {name:11s} " + ", ".join(row), flush=True)
            use(libs["committed"])
            for case, args in cases.items():
                _, kernels = cs.profile_path(lambda a=args: fk.framed_magnitude_kchunk(*a, 512))
                print(f"[profile] {mode:8s} {case}: " + "; ".join(
                    f"{k[:70]} {ms:.3f} ms x{c}" for k, (ms, c) in kernels.items()),
                    flush=True)
        config.set_matmul_precision("highest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
