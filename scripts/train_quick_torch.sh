#!/usr/bin/env bash
# Run all quick experiments back to back on the PyTorch port (the twin of
# scripts/train_quick.sh); on the card, or pass device=cpu.
set -euo pipefail
cd "$(dirname "$0")/.."

for exp in chest_base_vae_quick chest_beta_vae_quick multi_modal_cvae_quick \
           disentangled_multi_modal_cvae_quick; do
    echo "=== experiment: $exp ==="
    python -m medvae_tpu_torch.cli.train "experiment=$exp" "$@"
done
