"""Multi-process rendering on ``torch.distributed``.

Counterpart of ``raintpu.parallel``: :mod:`.distributed` starts the
process group and splits work lists between processes; :mod:`.mesh`
lays the ranks out as a (dp, sp) device mesh and renders a batch with
frames over dp and each frame's drops over sp.
"""
