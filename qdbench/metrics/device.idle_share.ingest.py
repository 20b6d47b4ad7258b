"""``device.idle_share.ingest`` (%): the share of the traced window in
which no kernel, copy or fill ran on the device."""


def read(obs):
    if obs.trace is None or not obs.trace.window_s:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
