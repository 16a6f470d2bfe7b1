"""Step dispatch (``Engine.warmup``, ``worker/graphs.py`` captures): the
seconds of the set-up's warm-up."""


def read(run):
    return run.phases.get("warmup")
