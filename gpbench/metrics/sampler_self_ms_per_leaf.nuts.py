"""The tree's own host milliseconds a leaf: self time of the program's spans nuts.leaf and nuts.transition (evaluations and host syncs left out) ÷ count(nuts.leaf)."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "SPANS", {})
    leaf, transition = spans.get("nuts.leaf"), spans.get("nuts.transition")
    return (leaf[2] + transition[2]) * 1e-6 / leaf[0] if leaf and transition else None
