"""The port's hand-written CUDA kernels, one package each (``ops``: the
wrappers, which dispatch by device; ``ref``: the plain versions;
``kernel``: the ctypes launchers of ``csrc``), and their ``build``.

Each wrapper counts its kernel's launches in ``.launches``;
``quant_matmul`` and ``quant_matmul_t`` also count them by the CUDA kernel
that ran, in ``.by_kernel``.  :func:`counted` is the one list of them, for
code that reads or moves the counts together (``runtime.graphs`` moves a
captured region's counts to its replays)."""


def counted() -> dict:
    """{name: wrapper} of every wrapper that counts its launches."""
    from repro_torch.kernels.attn_colsum.ops import attn_colsum
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.gptq_block.ops import solve_block
    from repro_torch.kernels.gram.ops import weighted_gram
    from repro_torch.kernels.hadamard.ops import fwht
    from repro_torch.kernels.quant_matmul.ops import (quant_matmul,
                                                      quant_matmul_t)

    return {"gram": weighted_gram, "attn_colsum": attn_colsum,
            "quant_matmul": quant_matmul, "quant_matmul_t": quant_matmul_t,
            "flash_decode": fd.flash_decode,
            "paged_flash_decode": fd.paged_flash_decode,
            "paged_flash_extend": fd.paged_flash_extend,
            "mla_flash_decode": fd.mla_flash_decode,
            "paged_mla_flash_decode": fd.paged_mla_flash_decode,
            "paged_mla_flash_extend": fd.paged_mla_flash_extend,
            "fwht": fwht, "solve_block": solve_block}
