"""The evaluation data layer: NIfTI volumes, the dataset registry and the
validation datasets."""
