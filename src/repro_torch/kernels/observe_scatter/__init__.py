"""observe_scatter — fused telemetry scatter for the epoch observe path.

One pass over a batch's block-id stream yields the two histograms every
collector update in ``telemetry.observe_all`` is an affine function of: the
access histogram (HMU saturating add, NB touched set, true-count add) and
the PEBS-sampled histogram (the ``(cursor + position) % period`` sampler,
optionally masked by a per-event keep mask).
"""
from .ops import observe_scatter
from .ref import observe_scatter_ref

__all__ = ["observe_scatter", "observe_scatter_ref"]
