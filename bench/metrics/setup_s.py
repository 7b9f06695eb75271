"""setup_s: seconds from the process's start to the window's opening:
weights drawn, the cluster built, kernels built (the first run of a
checkout), every prefill graph of the cell's buckets and the decode step
captured, the variant loaded and one query served."""


def read(run):
    return run.setup_s
