"""Probes of the port's kernels on the card, each the H100 counterpart of a
TPU probe in ``benchmarks/``: ``python -m groma_tpu_torch.benchmarks.<name>``.
"""
