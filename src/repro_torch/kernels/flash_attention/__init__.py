"""Flash attention: K6 (Hopper kernel), its plain torch version and the
torch op ``repro_torch::flash_attention_fwd`` that dispatches by device."""
