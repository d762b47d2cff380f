"""Time the compress kernels against older sources on the card, in one process.

  PYTHONPATH=src python -m repro_torch.launch.profile_compress [--source OLDER.cu ...]

Builds ``csrc/compress.cu`` as it stands and any other compress sources
given (an older ``compress.cu``, so that two versions are timed in one
call, on one card), each into its own library under
``build/kernels/variants/``, and prints each kernel's registers and spills.
For each variant, both kernels (without and with DP, C=1, σ=0.5) must be
``torch.equal`` to the plain version at the main path's message shape
([2900, 128]: 1290 rows of width 11, 320 of 64, 1290 of 128,
k = round(w/4)), at the large ragged shape ([16384, 1024], widths
1024/300/129, k = round(w/4)) and at dense [2900, w] for w = 32, 64, ...,
1024 (one register bucket each), all at b = 128; then each is timed there
(``launch/timing.py::device_ms``), in the order given and again reversed.
Prints the card, the launch floor (a one-element ``zero_()`` timed the
same way) and one JSON line per variant, kernel and shape. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.core.compression import compress_rows_ref
from repro_torch.kernels import build
from repro_torch.launch.timing import device_ms

VARIANT_DIR = build.BUILD_DIR / "variants"


def build_variant(name: str, source: Path) -> ctypes.CDLL:
    """nvcc ``source`` with the package's flags into
    ``build/kernels/variants/lib<name>.so``; loaded with the C signatures."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    out = VARIANT_DIR / f"lib{name}.so"
    proc = subprocess.run(build.nvcc_command(source, out, build.find_nvcc()), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    kernels = re.findall(r"Compiling entry function '(\w+)'", proc.stdout)
    regs = re.findall(r"Used (\d+) registers", proc.stdout)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", proc.stdout)
    print(f"[build] {name}: " + ", ".join(
        f"{k.split('compress_rows_')[-1]}: {r} registers, spills {st}/{ld} bytes"
        for k, r, (st, ld) in zip(kernels, regs, spills)))
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in build.SIGNATURES["compress"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def shapes(device):
    """{name: (mat, k, row_len)}: the main path's message shape, the large
    ragged shape, and dense [2900, w] for each register width w (one
    register bucket each), random normal values over each valid prefix."""
    out = {}
    g = torch.Generator(device=device).manual_seed(0)
    cases = [("main [2900, 128]", (11, 64, 128), (1290, 320, 1290), 128),
             ("large ragged [16384, 1024]", (1024, 300, 129), None, 1024)]
    cases += [(f"dense [2900, {w}]", (w,), (2900,), w) for w in (32, 64, 128, 256, 512, 1024)]
    for name, widths, counts, n in cases:
        if counts is None:
            len_rows = torch.tensor(widths, dtype=torch.int32)[torch.arange(16384) % 3]
        else:
            len_rows = torch.repeat_interleave(torch.tensor(widths, dtype=torch.int32),
                                               torch.tensor(counts))
        len_rows = len_rows.to(device)
        k_rows = torch.clamp_min(torch.round(len_rows.double() / 4), 1).to(torch.int32)
        mat = torch.randn((len_rows.numel(), n), generator=g, device=device)
        mat = torch.where(torch.arange(n, device=device) < len_rows[:, None], mat, 0.0)
        out[name] = (mat.contiguous(), k_rows, len_rows)
    return out


def launcher(lib, mat, k_rows, len_rows, levels: int, dp):
    """A call of ``lib``'s kernel on the current stream into a fixed output."""
    out = torch.empty_like(mat)
    rows, n = mat.shape

    def run():
        if dp is None:
            err = lib.compress_rows_f32(mat.data_ptr(), k_rows.data_ptr(), len_rows.data_ptr(),
                                        out.data_ptr(), rows, n, levels,
                                        torch.cuda.current_stream().cuda_stream)
        else:
            clip, sigma, noise = dp
            err = lib.compress_rows_dp_f32(mat.data_ptr(), k_rows.data_ptr(),
                                           len_rows.data_ptr(), noise.data_ptr(),
                                           clip.data_ptr(), sigma.data_ptr(), out.data_ptr(),
                                           rows, n, levels,
                                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.cuda_error_string(err).decode())
        return out

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_compress measures the card: no CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    variants = [("default", build.CSRC / "compress.cu")]
    variants += [(f"source:{p.stem}", p) for p in args.source]
    libs = {name: build_variant(name.replace(":", "_"), path) for name, path in variants}
    one = torch.zeros(1, device=device)
    print(f"[floor] one-element zero_(): {device_ms(one.zero_)} ms")
    cases = []
    for shape, (mat, k_rows, len_rows) in shapes(device).items():
        g = torch.Generator(device=device).manual_seed(1)
        dp = (torch.tensor(1.0, device=device), torch.tensor(0.5, device=device),
              torch.randn(mat.shape, generator=g, device=device))
        for kernel, dp_args in (("fused_compress", None), ("fused_compress_dp", dp)):
            want = compress_rows_ref(mat, k_rows, 128, len_rows, *(dp_args or ()))
            for name, lib in libs.items():
                got = launcher(lib, mat, k_rows, len_rows, 128, dp_args)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"{name} {kernel} at {shape}: differs from the plain version")
            cases.append((shape, kernel, mat, k_rows, len_rows, dp_args))
    times = {}
    order = list(libs) + list(reversed(libs))
    for name in order:
        for shape, kernel, mat, k_rows, len_rows, dp_args in cases:
            fn = launcher(libs[name], mat, k_rows, len_rows, 128, dp_args)
            times.setdefault((name, kernel, shape), []).append(device_ms(fn))
    for (name, kernel, shape), ms in times.items():
        print(json.dumps({"variant": name, "kernel": kernel, "shape": shape, "ms": ms,
                          "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
