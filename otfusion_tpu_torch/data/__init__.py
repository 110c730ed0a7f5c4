"""Host data layer: NIfTI I/O, preprocessing, cohorts, splits, loaders."""
