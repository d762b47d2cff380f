"""Time the compress kernels against older sources on the card, in one process.

  PYTHONPATH=src python -m repro_torch.launch.profile_compress [--source OLDER.cu ...]

Builds ``csrc/compress.cu`` as it stands and any other compress sources
given (an older ``compress.cu``, so that two versions are timed in one
call, on one card), each into its own library under
``build/kernels/variants/``, and prints each kernel's registers, shared
memory and spills (``-Xptxas -v``). For each variant, both kernels (without
and with DP, C=1, σ=0.5) must be ``torch.equal`` to the plain version at the
main path's message shape ([2900, 128]: 1290 rows of width 11, 320 of 64,
1290 of 128, k = round(w/4)), at the large ragged shape ([16384, 1024],
widths 1024/300/129, k = round(w/4)) and at dense [2900, w] for w = 32, 64,
..., 1024 (one register bucket each); the non-DP kernel also at the LLM
message groups past 1024 floats (``LLM_SHAPES``), and the DP kernel at
gemma3-1b's head with σ = 1; all at b = 128, k = 25 % at the LLM shapes.
Then each is timed there (``launch/timing.py::device_ms``), in the order
given and again reversed, and the legacy sort path (``torch.topk`` + a
separate quantize) at ``SORT_SHAPES`` by CUDA events. Prints the card, the
launch floor (a one-element ``zero_()`` timed the same way), the body the
current source runs at each width, and one JSON line per variant, kernel
and shape with its bound (``launch/timing.py::compress_bound_ms``, as
``chip_smoke.py`` reckons it). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.core.compression import compress_message_sort, compress_rows_ref
from repro_torch.kernels import build
from repro_torch.kernels.compress import kernel_body
from repro_torch.launch.timing import card_rates, compress_bound_ms, device_ms, event_median_ms

VARIANT_DIR = build.BUILD_DIR / "variants"
# The LLM message groups past 1024 floats (PERF.md §6): qwen2-vl-72b's MLP
# rows and head, whisper-medium's head, gemma3-1b's MLP rows, attention
# rows and head
LLM_SHAPES = ((16384, 29568), (1024, 51865), (59904, 6912), (206517, 1152), (8192, 152064),
              (1152, 262144))
DP_LLM_SHAPE = (1152, 262144)
SORT_SHAPES = ((16384, 29568), (8192, 152064), (1152, 262144))


def ptxas_report(log: str):
    """[(entry function, registers, shared-memory bytes, spill stores, spill
    loads)] from ``-Xptxas -v`` output."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out.append((name, int(regs.group(1)) if regs else None,
                    int(smem.group(1)) if smem else 0,
                    *(int(g) for g in (spill.groups() if spill else (0, 0)))))
    return out


def build_variant(name: str, source: Path) -> ctypes.CDLL:
    """nvcc ``source`` with the package's flags into
    ``build/kernels/variants/lib<name>.so``; loaded with the C signatures
    that it exports."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    out = VARIANT_DIR / f"lib{name}.so"
    proc = subprocess.run(build.nvcc_command(source, out, build.find_nvcc()),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    for fn, regs, smem, st, ld in ptxas_report(proc.stdout):
        print(f"[build] {name}: {fn}: {regs} registers, {smem} bytes static shared memory, "
              f"spills {st}/{ld} bytes")
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in build.SIGNATURES["compress"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def ragged(widths, counts, n, device, g):
    """A [rows, n] matrix of normals over each row's valid prefix, with the
    per-row k = round(w/4) and valid length w."""
    if counts is None:
        len_rows = torch.tensor(widths, dtype=torch.int32)[torch.arange(16384) % 3]
    else:
        len_rows = torch.repeat_interleave(torch.tensor(widths, dtype=torch.int32),
                                           torch.tensor(counts))
    len_rows = len_rows.to(device)
    k_rows = torch.clamp_min(torch.round(len_rows.double() / 4), 1).to(torch.int32)
    mat = torch.randn((len_rows.numel(), n), generator=g, device=device)
    mat = torch.where(torch.arange(n, device=device) < len_rows[:, None], mat, 0.0)
    return mat.contiguous(), k_rows, len_rows


def shapes(device):
    """[(name, mat, k, row_len, DP σ or None for no DP case)]: the main
    path's message shape, the large ragged shape and dense [2900, w] for
    each register width w (both kernels, σ = 0.5), then the LLM shapes
    (non-DP; DP at ``DP_LLM_SHAPE`` with σ = 1)."""
    out = []
    g = torch.Generator(device=device).manual_seed(0)
    cases = [("main [2900, 128]", (11, 64, 128), (1290, 320, 1290), 128),
             ("large ragged [16384, 1024]", (1024, 300, 129), None, 1024)]
    cases += [(f"dense [2900, {w}]", (w,), (2900,), w) for w in (32, 64, 128, 256, 512, 1024)]
    for name, widths, counts, n in cases:
        out.append((name, *ragged(widths, counts, n, device, g), (None, 0.5)))
    for rows, n in LLM_SHAPES:
        mat, k_rows, len_rows = ragged((n,), (rows,), n, device, g)
        out.append((f"LLM [{rows}, {n}]", mat, k_rows, len_rows,
                    (None, 1.0) if (rows, n) == DP_LLM_SHAPE else (None,)))
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
    for shape, mat, k_rows, len_rows, sigmas in shapes(device):
        n = mat.shape[1]
        print(f"[body] {shape}: {json.dumps(kernel_body(n, libs['default']))}")
        g = torch.Generator(device=device).manual_seed(1)
        for sigma in sigmas:
            dp = None if sigma is None else (
                torch.tensor(1.0, device=device), torch.tensor(sigma, device=device),
                torch.randn(mat.shape, generator=g, device=device))
            kernel = "fused_compress" if dp is None else f"fused_compress_dp sigma={sigma}"
            want = compress_rows_ref(mat, k_rows, 128, len_rows, *(dp or ()))
            for name, lib in libs.items():
                got = launcher(lib, mat, k_rows, len_rows, 128, dp)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"{name} {kernel} at {shape}: differs from the plain version")
                del got
            del want
            torch.cuda.empty_cache()
            cases.append((shape, kernel, mat, k_rows, len_rows, dp))
    times = {}
    order = list(libs) + list(reversed(libs))
    for name in order:
        for shape, kernel, mat, k_rows, len_rows, dp in cases:
            fn = launcher(libs[name], mat, k_rows, len_rows, 128, dp)
            big = mat.numel() > 1 << 26
            times.setdefault((name, kernel, shape), []).append(
                device_ms(fn, inner=2, reps=7) if big else device_ms(fn))
    bw, flops = card_rates(torch.cuda.get_device_name(0))
    for (name, kernel, shape), ms in times.items():
        mat, len_rows, dp = next((c[2], c[4], c[5]) for c in cases
                                 if c[0] == shape and c[1] == kernel)
        bound, bound_by = compress_bound_ms(mat, len_rows, 128, bw, flops, dp is not None)
        print(json.dumps({"variant": name, "kernel": kernel, "shape": shape, "ms": ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "bound_share": [bound / t for t in ms],
                          "device": torch.cuda.get_device_name(0)}))
    del cases
    torch.cuda.empty_cache()
    for rows, n in SORT_SHAPES:
        g = torch.Generator(device=device).manual_seed(rows + n)
        x = torch.randn((rows, n), generator=g, device=device)
        print(json.dumps({"variant": "legacy sort path (torch.topk + quantize)",
                          "shape": f"LLM [{rows}, {n}]",
                          "ms": event_median_ms(lambda: compress_message_sort(x, 0.25, 128)),
                          "device": torch.cuda.get_device_name(0)}))
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
