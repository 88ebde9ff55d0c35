"""Device kernels launched per 1,000 simulated invocations: the
profiler's kernel count over the window's invocations.  The host glue
around the step kernel (input building, phase sums, normalization)
launches all but a few of them, and the count repeats exactly."""


from perfbench.trace import is_copy


def read(run):
    s = run.summary
    if s is None or not s.kernels or not run.facts.get("work"):
        return None
    kernels = sum(1 for n, _, _ in s.kernels if not is_copy(n))
    return kernels / (run.facts["work"] / 1000.0)
