"""The share of profiled kernel time outside the matrix products
(cuBLAS and CUTLASS kernels) and outside the program's own hand-written
kernels: the element-wise, reduction and gather passes."""


def read(r):
    total = r.kernel_seconds(lambda n: True)
    if total <= 0:
        return None
    from benchmark.readings import MATMUL

    kept = r.kernel_seconds(
        lambda n: bool(MATMUL.search(n)) or r.is_port_kernel(n))
    return 1.0 - kept / total
