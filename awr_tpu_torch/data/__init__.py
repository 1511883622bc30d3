"""Host crop parameters, device crop/normalize/augment, the synthetic
dataset and the prefetching loader."""
