"""Algorithmic (non-kernel) MMA reductions: ``core.mma_reduce``."""
