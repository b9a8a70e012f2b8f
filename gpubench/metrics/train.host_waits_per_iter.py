"""train.host_waits_per_iter: host waits on the device in the trace of
the profiled iterations (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize: a blocking device-to-host copy is a stream
synchronize), over the iterations."""


def read(ctx):
    t = ctx.trace_data
    n = len(ctx.work.get("traced") or ())
    if t is None or not n:
        return None
    return t.waits / n
