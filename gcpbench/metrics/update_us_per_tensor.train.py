"""The update's host cost per tensor: microseconds in the program's
'train.grad_mask' and 'train.optimizer' spans over the gradients the steps
masked and handed to the optimizer ('train.update_tensors'), from the span
pass (host clock, nothing synchronised, so the waits of a full launch
queue are inside)."""


def read(run):
    span_pass = (run.get("program") or {}).get("span_pass") or {}
    seconds, tensors = span_pass.get("seconds", {}), span_pass.get("counts", {}).get(
        "train.update_tensors")
    if not tensors or "train.grad_mask" not in seconds:
        return None
    return 1e6 * (seconds["train.grad_mask"] + seconds.get("train.optimizer", 0.0)) / tensors
