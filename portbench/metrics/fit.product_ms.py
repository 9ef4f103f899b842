"""Mean device milliseconds of one GRM product over the window: CUDA
events that the benchmark's operator wrapper records around each
``matvec`` the fitter takes (kernels B1, B2, the slicing, recombination
and the missing-pair corrections together)."""


def read(ctx):
    ms = ctx["counters"].get("product_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
