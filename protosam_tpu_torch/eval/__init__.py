"""Evaluation: the ProtoSAM and ALPNet-only drivers and test-time
training, and the fold they open."""

from protosam_tpu_torch.data.medical import med_fewshot_val
from protosam_tpu_torch.utils.config import Config


def open_fold(cfg: Config, act_labels: list):
    """``med_fewshot_val`` on the eval fold of ``cfg``, from the data
    directory of ``<base>_672`` (inputs over 256 px) or ``<base>`` where
    ``data_dirs`` names it, else of ``cfg.dataset``.  Returns
    (ValidationDataset, MedicalVolumeDataset)."""
    base = cfg.dataset.split("_")[0]
    suffix = "_672" if cfg.input_size[0] > 256 else ""
    key = base + suffix if base + suffix in cfg.data_dirs else cfg.dataset
    return med_fewshot_val(
        dataset_name=base, base_dir=cfg.data_dir(key),
        idx_split=cfg.eval_fold, act_labels=act_labels,
        npart=cfg.n_sup_part, image_size=cfg.input_size[0],
        use_clahe=cfg.use_clahe, use_3_slices=cfg.use_3_slices)
