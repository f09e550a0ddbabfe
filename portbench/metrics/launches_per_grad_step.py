"""launches_per_grad_step: the CUDA kernels the profiler saw in the traced
window, over the Adam steps in it (the forward replay, its checkpointed
recomputation in the backward, the backward and the optimizer)."""


def read(run):
    if run.trace is None or not run.n_traced or not run.trace.kernels:
        return None
    return run.trace.count() / run.n_traced
