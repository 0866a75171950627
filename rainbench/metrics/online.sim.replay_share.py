"""online.sim.replay_share (%): the share of the window's untraced steps
in which the program replayed the online job's keyed simulation as a
CUDA graph (physics/simulator.SIM_GRAPHS): those whose online.drops span
(rainbench/harness.OnlineDrops, one a step, the last of them the
untraced steps) holds a sim.replay span. The two are matched by time: a
span the program opens inside the harness's carries the render step
before. A run on the CPU, or of a program without that graph (no
``SIM_GRAPHS``), reads nothing; one whose graph never engaged reads 0."""


def read(run):
    if run.device_name == "cpu":
        return None
    try:
        from raintpu_torch.physics.simulator import SIM_GRAPHS  # noqa: F401
        from raintpu_torch.utils.profiling import RING
    except ImportError:
        return None
    steps = len(run.step_s) - run.profiled_steps
    spans = list(RING)
    drops = [(t0, t1) for n, _, _, t0, t1 in spans if n == "online.drops"]
    drops = drops[-steps:] if steps > 0 else []
    if not drops:
        return None
    replays = [(t0, t1) for n, _, _, t0, t1 in spans if n == "sim.replay"]
    held = sum(any(a <= t0 and t1 <= b for t0, t1 in replays)
               for a, b in drops)
    return 100.0 * held / len(drops)
