"""One reader a metric: read(run) returns the metric's value from what a
run measured (run.py's Run), or None where the run has nothing to read;
SPANS {span: (target, attribute)} names the calls a traced run wraps for
it ("encoder" or "pipeline"), KERNELS the rooflines/ whose launches it
records during the profiled stretch."""
