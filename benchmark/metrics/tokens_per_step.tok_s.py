"""The engine and scheduler (``EngineStats`` over the window): output
tokens a dispatched step."""


def read(run):
    steps = run.stats.get("num_steps", 0)
    return run.stats["num_tokens_generated"] / steps if steps else None
