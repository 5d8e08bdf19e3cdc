"""The data layer: NIfTI volumes, the dataset registry, the validation
datasets, and the superpixel training episodes and their augmentations."""
