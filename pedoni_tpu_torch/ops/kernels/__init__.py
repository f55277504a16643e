"""Hand-written CUDA kernels (csrc/) with their plain PyTorch twins."""


def _counters() -> dict[str, tuple[object, str]]:
    """Each count of ``launch_counts`` as (the wrapper, its attribute)."""
    from . import flat_integrate as fi
    from . import flat_pairwise as fp
    from . import flat_sample as fs
    from . import flat_scatter as fc
    from . import pairwise as pw
    from . import rebin as rb
    from . import spawn_scatter as ss
    from . import step_kernel as sk
    return {"step_kernel": (sk.fused_step, "launches"),
            "step_kernel_movers": (sk.fused_step, "mover_launches"),
            "step_kernel_segments": (sk.fused_step, "segment_launches"),
            "rebin": (rb.rebin, "launches"),
            "rebin_incremental": (rb.rebin_incremental, "launches"),
            "pairwise": (pw.pairwise, "launches"),
            "flat_pairwise": (fp.flat_pairwise, "launches"),
            "flat_sample": (fs.flat_sample, "launches"),
            "flat_scatter": (fc.flat_scatter, "launches"),
            "flat_integrate": (fi.flat_integrate, "launches"),
            "spawn_scatter": (ss.spawn_scatter, "launches")}


def launch_counts() -> dict[str, int]:
    """Each wrapper's count of its kernel's launches, by kernel and mode:
    a wrapper adds one where it launches on the card, never on the CPU."""
    return {k: getattr(f, a) for k, (f, a) in _counters().items()}


def zero_launch_counts() -> None:
    """Set every count of ``launch_counts`` to 0."""
    for f, a in _counters().values():
        setattr(f, a, 0)


def add_launch_counts(moved: dict[str, int]) -> None:
    """Add ``moved`` (by the keys of ``launch_counts``) to the counts: a
    CUDA graph's replay adds the launches it holds, and its capture, which
    launches nothing, takes back those its wrappers counted."""
    counters = _counters()
    for k, n in moved.items():
        f, a = counters[k]
        setattr(f, a, getattr(f, a) + n)
