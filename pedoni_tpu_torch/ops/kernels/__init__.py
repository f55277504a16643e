"""Hand-written CUDA kernels (csrc/) with their plain PyTorch twins."""


def launch_counts() -> dict[str, int]:
    """Each wrapper's count of its kernel's launches, by kernel and mode:
    a wrapper adds one where it launches on the card, never on the CPU."""
    from . import flat_integrate as fi
    from . import flat_pairwise as fp
    from . import flat_sample as fs
    from . import flat_scatter as fc
    from . import pairwise as pw
    from . import rebin as rb
    from . import spawn_scatter as ss
    from . import step_kernel as sk
    return {"step_kernel": sk.fused_step.launches,
            "step_kernel_movers": sk.fused_step.mover_launches,
            "step_kernel_segments": sk.fused_step.segment_launches,
            "rebin": rb.rebin.launches,
            "rebin_incremental": rb.rebin_incremental.launches,
            "pairwise": pw.pairwise.launches,
            "flat_pairwise": fp.flat_pairwise.launches,
            "flat_sample": fs.flat_sample.launches,
            "flat_scatter": fc.flat_scatter.launches,
            "flat_integrate": fi.flat_integrate.launches,
            "spawn_scatter": ss.spawn_scatter.launches}


def zero_launch_counts() -> None:
    """Set every count of ``launch_counts`` to 0."""
    from . import flat_integrate as fi
    from . import flat_pairwise as fp
    from . import flat_sample as fs
    from . import flat_scatter as fc
    from . import pairwise as pw
    from . import rebin as rb
    from . import spawn_scatter as ss
    from . import step_kernel as sk
    sk.fused_step.launches = sk.fused_step.mover_launches = 0
    sk.fused_step.segment_launches = 0
    rb.rebin.launches = rb.rebin_incremental.launches = 0
    pw.pairwise.launches = fp.flat_pairwise.launches = 0
    fs.flat_sample.launches = fc.flat_scatter.launches = 0
    fi.flat_integrate.launches = ss.spawn_scatter.launches = 0
