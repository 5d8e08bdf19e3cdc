"""The hand-written kernels' wrappers and their plain versions."""


def launch_counts() -> dict[str, int]:
    """The launches of the hand-written kernels K1-K9 so far, from each
    wrapper's ``launches`` (the plain versions on a CPU tensor count
    none)."""
    from protosam_tpu_torch.ops.alp import alp_match_fused
    from protosam_tpu_torch.ops.attention import \
        masked_flash_attention_packed
    from protosam_tpu_torch.ops.cca import label_components
    from protosam_tpu_torch.ops.mlp import dense_residual, mlp_fused
    from protosam_tpu_torch.ops.norm import layer_norm_rows
    from protosam_tpu_torch.ops.quant import (int8_matmul_dequant,
                                              quantize_rows)
    from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention

    return {"K1": layer_norm_rows.launches,
            "K2": masked_flash_attention_packed.launches,
            "K3": label_components.launches,
            "K4": relpos_patch_attention.launches,
            "K5": alp_match_fused.launches, "K6": dense_residual.launches,
            "K7": mlp_fused.launches, "K8": quantize_rows.launches,
            "K9": int8_matmul_dequant.launches}
