"""Launch calls (kernels, copies, memsets; any thread) inside the program's
'train_step' spans, per profiled step of the tree."""
from gcpbench.program_trace import read_launches_per_step_train as read  # noqa: F401
