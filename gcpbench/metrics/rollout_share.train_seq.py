"""Share of a VRNN train step's host time in its rollout: the program's
'model.rollout' and 'rollout.bwd' seconds over its 'train_step' seconds, from
the span pass (host clock, nothing synchronised)."""


def read(run):
    seconds = ((run.get("program") or {}).get("span_pass") or {}).get("seconds", {})
    if not seconds.get("model.rollout") or not seconds.get("train_step"):
        return None
    return 100.0 * (seconds["model.rollout"] + seconds.get("rollout.bwd", 0.0)) \
        / seconds["train_step"]
