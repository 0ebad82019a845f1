"""guard_tpu_torch: the PyTorch + CUDA port of guard-tpu's batch engine.

A second package beside the JAX reference (`guard_tpu`): it keeps its
own copies of the host-side modules it needs and imports neither JAX
nor `guard_tpu`. It runs `validate --statuses-only` end to end on one
CUDA device: parse, precompute function values on the host, encode,
lower, the batched torch walk with six hand-written CUDA kernels
(`csrc/guard_kernels.cu`, `csrc/guard_joins.cu`), the rim reductions,
oracle reruns of the documents the device cannot decide on the CPU
evaluator (`core/evaluator.py`), and the console report. A seventh
kernel counts each rule's PASS, FAIL and SKIP documents for
`parallel.device.DeviceBatchEvaluator.with_summary`; `entry.py` holds
the entry points (`python -m guard_tpu_torch.entry`).
"""
