#!/usr/bin/env bash
# Full-size experiments on the PyTorch port (the twin of scripts/train_all.sh);
# on the card, or pass device=cpu.
set -euo pipefail
cd "$(dirname "$0")/.."

for exp in chest_base_vae path_beta_vae multi_modal_cvae; do
    echo "=== experiment: $exp ==="
    python -m medvae_tpu_torch.cli.train "experiment=$exp" "$@"
done
