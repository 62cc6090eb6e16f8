"""Block-sparse (BCSR) times dense: the SpMM of the BSR bridge.

Replaces ``repro/kernels/spmm_bsr.py::spmm_bsr``. The TPU kernel walks the
grid (block row, N tile, slot) in order and keeps the output tile in VMEM
while the row's blocks stream through the MXU. The CUDA kernels
(``csrc/spmm_bsr.cu``) give one CTA each output tile of a block row and
let it loop over the row's live slots, accumulating in registers.

It is bound by operations at the bridge's shapes (2 * live blocks * bs^2 *
N FLOPs). Two routes, chosen from the shape alone (``route``):

* ``"tensor_cores"`` for bs >= 16 when the rows of ``c`` are 16-byte
  aligned (N a multiple of 4 for float32, of 8 for bfloat16): 128 x 128
  output tiles, ``mma.sync`` fed by a ``cp.async`` ring over (slot, k
  chunk) steps, float32 in 3xTF32 (within ``3 * 2^-22`` of each exact
  product, so integers up to 2^11 multiply exactly), bfloat16 in one bf16
  pass;
* ``"cuda_cores"`` for every other shape (``bs`` 1 to 8, ragged N): float32
  FMA with both operand tiles in shared memory, the first version.

Layout (as in the reference):
  blk_map : (n_brow, max_nnz) int32, flat block per slot; nnzb pads
  col_idx : (n_brow, max_nnz) int32, block column per slot
  blocks  : (nnzb + 1, bs, bs) float32 or bfloat16; the last is all zeros
  c       : (K, N), the same dtype   ->  out (n_brow * bs, N) in that dtype

Sums accumulate in float32. Pad slots are skipped, not multiplied by the
zero block: the results differ from the reference's only where C holds inf
or NaN. ``bs`` is any power of two; K and N are any extents (the
reference's ``N % n_tile == 0`` assert is gone).
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
ROUTES = ("tensor_cores", "cuda_cores")


def route(bs: int, n: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these shapes launches (module
    docstring): ``"tensor_cores"`` or ``"cuda_cores"``."""
    if bs >= 16 and n % (16 // dtype.itemsize) == 0:
        return "tensor_cores"
    return "cuda_cores"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on a 16-byte boundary (a view may
    start inside its storage), as the tensor-core kernels copy 16 bytes at
    a time."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def spmm_bsr_plain(blk_map: torch.Tensor, col_idx: torch.Tensor,
                   blocks: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: densify the BCSR matrix from
    its live slots and multiply, in float32 (PyTorch's default float32
    matmul, which is not TF32)."""
    n_brow, max_nnz = blk_map.shape
    bs = blocks.shape[1]
    nnzb = blocks.shape[0] - 1
    k_dim = c.shape[0]
    n_bcol = -(-k_dim // bs)
    bm = blk_map.reshape(-1).long()
    ci = col_idx.reshape(-1).long()
    brow = torch.arange(n_brow, device=c.device).repeat_interleave(max_nnz)
    live = (bm >= 0) & (bm < nnzb)
    dense = torch.zeros((n_brow, n_bcol, bs, bs), dtype=torch.float32,
                        device=c.device)
    dense.index_put_((brow[live], ci[live]), blocks[bm[live]].float(),
                     accumulate=True)
    dense = dense.permute(0, 2, 1, 3).reshape(n_brow * bs, n_bcol * bs)
    return (dense[:, :k_dim] @ c.float()).to(c.dtype)


def _check_bs(bs: int, kernel: str) -> None:
    if bs < 1 or bs & (bs - 1):
        raise ValueError(f"{kernel}: block size {bs} is not a power of two")


def spmm_bsr(blk_map: torch.Tensor, col_idx: torch.Tensor,
             blocks: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """out = BCSR(blocks) @ c (module docstring for the layout).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``route``, counted in ``spmm_bsr.route_launches`` beside the total
    ``spmm_bsr.launches``.
    """
    args = (blk_map, col_idx, blocks, c)
    if all(t.device.type == "cpu" for t in args):
        return spmm_bsr_plain(*args)
    if any(t.device != c.device for t in args) or c.device.type != "cuda":
        raise ValueError("spmm_bsr: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in args]}")
    if blocks.dtype != c.dtype or c.dtype not in _DTYPES:
        raise TypeError(f"spmm_bsr takes float32 or bfloat16 blocks and C "
                        f"of one dtype, not {blocks.dtype} and {c.dtype}")
    if (blk_map.dim() != 2 or col_idx.shape != blk_map.shape
            or blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]
            or c.dim() != 2):
        raise ValueError(f"spmm_bsr: shapes blk_map {tuple(blk_map.shape)}, "
                         f"col_idx {tuple(col_idx.shape)}, blocks "
                         f"{tuple(blocks.shape)}, c {tuple(c.shape)}")
    bs = blocks.shape[1]
    _check_bs(bs, "spmm_bsr")
    n_brow, max_nnz = blk_map.shape
    k_dim, n = c.shape
    if -(-n // 64) > 65535:
        raise ValueError(f"spmm_bsr: N = {n} needs more than 65535 "
                         f"column tiles")
    bm = blk_map.to(torch.int32).contiguous()
    ci = col_idx.to(torch.int32).contiguous()
    blocks = _aligned(blocks)
    c = _aligned(c)
    out = torch.empty((n_brow * bs, n), dtype=c.dtype, device=c.device)
    if out.numel():
        way = route(bs, n, c.dtype)
        entry = "sam_spmm_bsr_" + ("tc_" if way == "tensor_cores" else "")
        _build.call(entry + _DTYPES[c.dtype], bm.data_ptr(), ci.data_ptr(),
                    blocks.data_ptr(), c.data_ptr(), out.data_ptr(), n_brow,
                    max_nnz, blocks.shape[0] - 1, bs, k_dim, n)
        spmm_bsr.launches += 1
        spmm_bsr.route_launches[way] += 1
    return out


spmm_bsr.launches = 0
spmm_bsr.route_launches = dict.fromkeys(ROUTES, 0)
