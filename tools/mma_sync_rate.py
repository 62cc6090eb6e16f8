#!/usr/bin/env python3
"""Peak rate of mma.sync on this card, for the tensor-core kernels' bounds.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 tools/mma_sync_rate.py

Builds ``tools/mma_sync_rate.cu`` into ``build/`` and times 16 independent
accumulator chains a warp, at 4, 8 and 16 warps an SM, for the two
products the port's kernels issue: m16n8k8 TF32 (float32 data, three of
them a product in 3xTF32) and m16n8k16 bf16. Prints TFLOP/s by CUDA events
beside the card's name and power limit. The data sheet's 495 (TF32) and
989 (bf16) TFLOP/s are wgmma's; this is what mma.sync reaches.
"""
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_sync_rate: no CUDA device", file=sys.stderr)
        return 2
    lib_path = ROOT / "build" / "mma_sync_rate.so"
    lib_path.parent.mkdir(exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(ROOT / "tools" / "mma_sync_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 128, device="cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for tf32, flop, name in ((1, 2048, "tf32 m16n8k8"),
                             (0, 4096, "bf16 m16n8k16")):
        for warps in (4, 8, 16):
            blocks, iters = sms * warps // 4, 4096
            if lib.mma_probe(tf32, blocks, 128, 16, out.data_ptr()):
                raise RuntimeError("mma_probe failed to launch")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.mma_probe(tf32, blocks, 128, iters, out.data_ptr())
            end.record()
            torch.cuda.synchronize()
            products = blocks * 4 * 16 * iters
            print(f"{name}: {warps} warps an SM, "
                  f"{products * flop / start.elapsed_time(end) / 1e9:.1f} "
                  f"TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
