"""Tools of the port, each run as ``python -m audioldm_tpu_torch.tools.<name>``:
``bench_attn`` (K1 beside PyTorch's fused attention) and ``bench_attn_diag``
(the diagnostic kernels K7-K10) on the GPU; ``bench_serving`` (sampler
latency and serving throughput); ``bench_dataprep`` (batch data prep);
``ckpt_drill`` (a written checkpoint through ``cli generate``, held to a CPU
replay) and ``eval_drill`` (``cli score`` held to transformers); and the
kernel probes ``devtime``, ``sass_guard`` and the ``*_variants`` tools."""
