"""FedFiTS in PyTorch on an NVIDIA H100 — the port of ``src/repro``.

The module layout mirrors the JAX package (``configs``, ``models``,
``data``, ``core``, ``comm``, ``kernels``) so each module's counterpart is
found under the same name.  This slice covers the synchronous FedFiTS
round (``core.fedfits.run``) over the paper's CNN/MLP, with the robust
Eq.-11 aggregation kernels written in CUDA C++ for ``sm_90a``
(``csrc/robust_pipeline.cu``).

The package imports torch and numpy only — never jax, never ``repro``.
Entry points (``core.fedfits.run``, ``data.pipeline.build_federation``)
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
