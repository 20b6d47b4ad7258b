"""``fused_ingest_roofline`` (%): the fold's least time over its device
time.  The least time of the traced batches is the frozen bound
(``qdbench/bound.py``), counted from the layout file and the rows; the
device time is every kernel named ``fused_ingest*`` in the trace.  Nothing
is read if the trace kept fewer of those kernels than the launch counters
say were launched in it."""


def read(obs):
    if obs.trace is None or not obs.traced_batches:
        return None
    seconds, events = obs.trace.kernel_seconds("fused_ingest")
    launched = sum(n for k, n in obs.traced_launches.items()
                   if k.startswith("fused_ingest"))
    if not seconds or events < launched:
        return None
    return 100.0 * obs.bound_s_per_batch * obs.traced_batches / seconds
