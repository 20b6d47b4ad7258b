"""``engine.plan_builds.ingest`` (builds): plans the program built over the
window (``engine.plan.build_counts``); a warm plan cache builds none."""


def read(obs):
    return float(sum(obs.builds.values()))
