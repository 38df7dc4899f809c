#!/usr/bin/env python3
"""A/B of builds of ``nnaudio_tpu_torch/csrc/framed_tc.cu`` on one NVIDIA GPU.

    python3 tools/framed_tc_ab.py [--source OTHER_framed_tc.cu ...]

Builds the package's source as it is and with the register split of the
multiplying / loading warpgroups changed (208/48 for both storage types,
216/40 for both), each into its own library. Prints each build's spill
instructions by warpgroup role (as ``chip_smoke.py``'s ``[build]`` lines do),
then swaps the builds under the wrappers and times K1 and K5 at the STFT
2048/512 shape, K2 at the classifier's and K4 at mel -> audio's, in fp32 and
bf16 storage, in turns (committed, the others, then in reverse), with CUDA
events and every output held bit-equal to the committed build's. A
``--source`` file (another version of the kernel, say from an older commit)
is built too and reports its spill sites only. Needs CUDA and nvcc.
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
from nnaudio_tpu_torch.features import MelSpectrogram, STFT  # noqa: E402
from nnaudio_tpu_torch.ops import build, framed_kernels as fk  # noqa: E402

SPLITS = {"float": ("  static constexpr int MULTIPLIER_REGS = 216;\n"
                    "  static constexpr int LOADER_REGS = 40;\n"),
          "bf16": ("  static constexpr int MULTIPLIER_REGS = 208;\n"
                   "  static constexpr int LOADER_REGS = 48;\n")}


def split(multiplier: int, loader: int) -> str:
    return (f"  static constexpr int MULTIPLIER_REGS = {multiplier};\n"
            f"  static constexpr int LOADER_REGS = {loader};\n")


def variants(src: str) -> dict[str, str]:
    for text in SPLITS.values():
        if src.count(text) != 1:
            raise SystemExit("framed_tc.cu's register split is not where this tool expects it")
    return {"committed": src,
            "208/48 both": src.replace(SPLITS["float"], split(208, 48)),
            "216/40 both": src.replace(SPLITS["bf16"], split(216, 40))}


def compile_all(sources: dict[str, str], out: Path) -> dict[str, Path]:
    jobs = {}
    for name, text in sources.items():
        cu = out / f"{len(jobs)}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        jobs[name] = (lib, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                             "-o", str(lib), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def use(lib: ctypes.CDLL) -> None:
    fk._fns.clear()
    for fn, (lib_name, argtypes) in fk._SIGNATURES.items():
        if lib_name == "framed_tc":
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            fk._fns[fn] = f


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", default=[],
                        help="another framed_tc.cu to build for its spill sites")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("framed_tc_ab: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {cs.smi()}")
    src = (build.CSRC / "framed_tc.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        extra = {f"--source {p}": Path(p).read_text() for p in args.source}
        libs = compile_all({**variants(src), **extra}, Path(tmp))
        for name, lib in libs.items():
            for func, by_role in (cs.spill_report(lib, build._nvcc()) or {}).items():
                if "framed_tc_kernel" in func:
                    print(f"[spills] {name:24s} {cs.kernel_label(func)}: multiplying "
                          f"{by_role['multiplying']}, loading {by_role['loading']}")
        timed = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items() if name in variants(src)}

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        st1 = STFT(n_fft=1024, hop_length=256, verbose=False, device=dev)
        st2 = STFT(n_fft=2048, hop_length=512, verbose=False, device=dev)
        # a copy of the filterbank, no transform's own: dense K2 (framed_tc),
        # never K2's FFT route
        fb = MelSpectrogram(sr=16000, n_fft=1024, hop_length=256, n_mels=64,
                            verbose=False, device=dev).mel_basis.clone()
        xa = torch.randn(32, 161024, generator=gen, device=dev)
        xb = torch.randn(32, 222548, generator=gen, device=dev)
        xe = torch.randn(32, 221524, generator=gen, device=dev)
        S = torch.rand(32, 513, 862, generator=gen, device=dev)
        p = [torch.randn(32, 513, 862, generator=gen, device=dev).bfloat16() for _ in range(2)]
        cases = {
            "K1 (b)": lambda: fk.framed_magnitude(xb, st2.wcos, st2.wsin, 512),
            "K5 (b)": lambda: fk.framed_pair(xb, st2.wcos, st2.wsin, 512)[0],
            "K2 (a)": lambda: fk.framed_filterbank(xa, st1.wcos, st1.wsin, fb, 256, eps=1e-8),
            "K4 (e)": lambda: fk.gl_step(xe, st1.wcos, st1.wsin, S, *p, 256, cs.MOM)[0],
        }
        order = list(timed) + list(reversed(timed))
        for mode in ("highest", "default"):
            config.set_matmul_precision(mode)
            ref = {}
            for name in order:
                use(timed[name])
                row = []
                for case, fn in cases.items():
                    out = fn()
                    torch.cuda.synchronize()
                    if case not in ref:
                        ref[case] = out.clone()
                    elif not torch.equal(ref[case], out):
                        raise SystemExit(f"{name} {case} {mode}: output differs from the committed build")
                    row.append(f"{case} {cs.cuda_ms(fn, queue_ahead=True):.3f} ms")
                print(f"[time] {mode:8s} {name:12s} " + ", ".join(row), flush=True)
        config.set_matmul_precision("highest")
    print("[done] outputs bit-equal across builds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
