"""Bench tools of the port: ``bench_attn`` (K1 beside PyTorch's fused
attention) and ``bench_attn_diag`` (the diagnostic kernels K7-K10), each run
as ``python -m audioldm_tpu_torch.tools.<name>`` on the GPU."""
