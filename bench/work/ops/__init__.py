"""One module a kernel op of ``repro_torch.kernels.ops``: ``work(*args,
**kwargs)`` takes the op's call arguments and returns (a callable giving
the forward's (flops, bytes), the products' peak rate, the backward's
(flops, bytes) where the call builds a graph, else None), by
``bench.work.kernels``' conventions."""
