#!/usr/bin/env python3
"""A/B of builds of ``nnaudio_tpu_torch/csrc/synthesis_ola.cu`` (K3) on one
NVIDIA GPU.

    python3 tools/synthesis_ab.py [--source OTHER_synthesis_ola.cu ...]

Builds the package's source as it is and changed by text: how many steps of
spectra the loaders copy ahead (``AHEAD``), the depth of the ring, and three
diagnostic builds that each leave one part of a step out (the loaders'
copies, their transpose, or the products) and so compute garbage: the time
that remains is the time of the other parts. A ``--source`` file (another
version of the kernel with the same entry point, e.g. an older commit's) is
built beside them; its arithmetic may differ, so its outputs are held
against the committed build's within the kernels' tolerance (1e-4 of max
|ref| in fp32 storage, 5e-2 in bf16) instead of bit for bit. Times K3 at
the STFT 2048/512 shape (B=32, F=1025, T=431), at mel -> audio's 1024/256
(T=862, F=513) and at the pyramid inverse's dual bank of CQT2010v2() at its
defaults (F=84, N=32386, hop 512, T=431) in fp32 and bf16 storage with CUDA
events, in turns (committed, the others, then in reverse), every output of a
build that is not diagnostic held bit-equal to the committed build's. Needs
CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nnaudio_tpu_torch import config  # noqa: E402
from nnaudio_tpu_torch.ops import build, framed_kernels as fk  # noqa: E402

AHEAD = "constexpr int AHEAD = 3;\n"
STAGES = ("  static constexpr int STAGES = 3;    // 48 KB each\n",
          "  static constexpr int STAGES = 4;    // 32 KB each\n")
TRANSPOSE = "      transpose_spectra<S, BT>("
COPY = "        copy_spectra<S, BT>("
PRODUCT = "    consume_step<BT, KAHAN>("


def variants(src: str) -> dict[str, tuple[str, bool]]:
    """{name: (source, diagnostic)}"""
    for text in (AHEAD, *STAGES, TRANSPOSE, COPY, PRODUCT):
        if src.count(text) != 1:
            raise SystemExit(f"synthesis_ola.cu has no single {text.strip()!r}")

    def off(text):  # the call left out: `if (false)` before it
        return src.replace(text, text[:len(text) - len(text.lstrip())] + "if (false) "
                           + text.lstrip())
    return {
        "committed": (src, False),
        "AHEAD 1": (src.replace(AHEAD, "constexpr int AHEAD = 1;\n"), False),
        "AHEAD 2": (src.replace(AHEAD, "constexpr int AHEAD = 2;\n"), False),
        "stages 2 / 3": (src.replace(STAGES[0], STAGES[0].replace("3;", "2;"))
                         .replace(STAGES[1], STAGES[1].replace("4;", "3;")), False),
        "no copies": (off(COPY), True),
        "no transpose": (off(TRANSPOSE), True),
        "no products": (off(PRODUCT), True),
    }


def compile_all(sources: dict[str, str], out: Path) -> dict[str, Path]:
    jobs = {}
    for name, text in sources.items():
        cu = out / f"{len(jobs)}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def use(lib: ctypes.CDLL) -> None:
    fn = "nnaudio_synthesis_ola"
    f = getattr(lib, fn)
    f.argtypes, f.restype = fk._SIGNATURES[fn][1], ctypes.c_int
    fk._fns[fn] = f


def main() -> int:
    if not torch.cuda.is_available():
        print("synthesis_ab: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", action="append", default=[],
                        help="another synthesis_ola.cu to time beside the committed one")
    args = parser.parse_args()
    print(f"[card] {cs.smi()}")
    src = (build.CSRC / "synthesis_ola.cu").read_text()
    builds = variants(src)
    # (source, diagnostic, held within the tolerance instead of bit for bit)
    builds = {k: (*v, False) for k, v in builds.items()}
    builds.update({f"--source {Path(p).name}": (Path(p).read_text(), False, True)
                   for p in args.source})
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all({k: v[0] for k, v in builds.items()}, Path(tmp))
        loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)

        def inputs(f, t, n):
            return (torch.randn(32, f, t, generator=gen, device=dev),
                    torch.randn(32, f, t, generator=gen, device=dev),
                    torch.randn(f, n, generator=gen, device=dev) / n,
                    torch.randn(f, n, generator=gen, device=dev) / n)
        cases = {"(b) 2048/512": (inputs(1025, 431, 2048), 512),
                 "(e) 1024/256": (inputs(513, 862, 1024), 256),
                 "(n) 84x32386/512": (inputs(84, 431, 32386), 512)}
        order = list(loaded) + list(reversed(loaded))
        for mode in ("highest", "default"):
            config.set_matmul_precision(mode)
            ref = {}
            for name in order:
                use(loaded[name])
                row = []
                for case, (args, hop) in cases.items():
                    def fn():
                        return fk.synthesis_ola(*args, hop)
                    out = fn()
                    torch.cuda.synchronize()
                    if case not in ref:
                        ref[case] = out.clone()
                    elif builds[name][2]:
                        err = cs.rel_err(out, ref[case])
                        if err > cs.TOL[mode]:
                            raise SystemExit(f"{name} {case} {mode}: {err:.2e} from the "
                                             "committed build")
                    elif not builds[name][1] and not torch.equal(ref[case], out):
                        raise SystemExit(f"{name} {case} {mode}: output differs from "
                                         "the committed build")
                    row.append(f"{case} {cs.cuda_ms(fn, queue_ahead=True):.3f} ms")
                tag = " (diagnostic)" if builds[name][1] else ""
                print(f"[time] {mode:8s} {name:14s} " + ", ".join(row) + tag, flush=True)
        config.set_matmul_precision("highest")
    print("[done] the outputs of every build that is not diagnostic bit-equal, those of "
          "--source builds within the tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
