"""render.prep.replay_share (%): the share of the window's untraced
steps in which the program replayed its per-drop prep as a CUDA graph,
that is, in which its span render.prep.replay opened
(render/frame.PREP_GRAPHS; the steps as rainbench/spans.py takes them).
A run on the CPU, or of a program without that graph (no
``PREP_GRAPHS``), reads nothing; one whose graph never engaged reads
0."""


def read(run):
    if run.device_name == "cpu":
        return None
    try:
        from raintpu_torch.render.frame import PREP_GRAPHS  # noqa: F401
        from raintpu_torch.utils.profiling import stage_ms
    except ImportError:
        return None
    steps = len(run.step_s) - run.profiled_steps
    ms = stage_ms("render.prep.replay", steps) if steps > 0 else []
    if not ms:
        return None
    return 100.0 * sum(m > 0 for m in ms) / len(ms)
