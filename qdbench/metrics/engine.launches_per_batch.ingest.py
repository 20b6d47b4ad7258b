"""``engine.launches_per_batch.ingest`` (launches): the kernel launches the
program's counters (``kernels._build.launch_counts``) moved by over the
window, over the batches handed to the entry in it."""


def read(obs):
    if not obs.batches:
        return None
    return sum(obs.launches.values()) / obs.batches
