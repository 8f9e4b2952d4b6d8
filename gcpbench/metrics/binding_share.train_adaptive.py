"""The adaptive binding's share of a train step's device time: the device
seconds of the operations launched inside the program's 'model.binding',
'binding.nll' and 'binding.bwd' spans (the cost matrix, K3, the posterior,
the expected NLL and its backward, the distance predictor) over those
launched inside its 'train_step' spans, matched by the profiler's
correlation id on any thread, over the profiled pass."""


def read(run):
    spans = ((run.get("program") or {}).get("profiled") or {}).get("spans", {})
    device = run.get("device_s") or {}
    if not spans.get("binding.nll") or not device.get("train_step"):
        return None
    return 100.0 * device["binding"] / device["train_step"]
