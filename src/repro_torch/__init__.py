"""PyTorch/CUDA port of the HBM data-analytics system (range selection,
hash join, the query stack) for one NVIDIA H100.

The subpackages mirror ``repro``'s layout so each module's counterpart is
easy to find.  Plain tensor code is PyTorch; the accelerated operators are
hand-written CUDA kernels built from ``kernels/csrc`` at first use.  This
package imports neither ``jax`` nor ``repro``.

    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Q, Executor

    cat = catalog_from_arrays({"lineitem": {...}, "orders": {...}})
    ex = Executor(cat)                  # runs on cuda; device="cpu" to opt out
    total = ex.execute(q, mode="batch").value
"""
