"""Tiny cells for the CPU tests: each of the benchmark's cells with its
configuration cut to a size a test run holds (the widths and depth cut,
every layer kind kept), its traffic mix shortened, and its limits as
committed."""

from __future__ import annotations

import copy

from portbench.common import cell_spec

TINY_MODEL = {
    "flagship224": {"hidden_channels": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
                    "resolution": 32, "shared_latent_dim": 4, "modality_latent_dim": 4, "latent_dim": 8},
    "gan224": {"hidden_channels": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
               "resolution": 32, "latent_dim": 4},
}


def tiny_cell(name: str, **mix) -> dict:
    cell = copy.deepcopy(cell_spec(name))
    cfg = cell["model"]
    cfg["model"].update(TINY_MODEL[cell["config"]])
    cfg["data"].update(size=32, batch_size=4)
    if cfg["loss"].get("clip_encoder") == "vit":
        cfg["loss"]["clip_encoder"] = "simple"
    if "discriminator" in cfg:
        cfg["discriminator"].update(ndf=8, n_layers=2)
    cfg["kernel_sites"] = {}
    cell["mix"].update({"split_rows": 64, "requests_sample": 6, "batches_sample": 2}, **mix)
    return cell
