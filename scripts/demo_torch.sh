#!/usr/bin/env bash
# End-to-end demo of the PyTorch port (the twin of scripts/demo.sh): forward
# smoke + the full CLI chain on one checkpoint —
#   train-quick -> generate -> evaluate -> analyze -> serve round-trip.
#
# Artifacts land under <repo>/logs/demo_torch/ (override with DEMO_LOG_DIR):
#   checkpoints/<exp>/{last,final,...}   train outputs + metrics.jsonl etc.
#   generate/   sample grids (PNG)
#   evaluate/   metrics.json + reconstructions
#   analyze/    latent-space stats
#   serve.json  round-trip proof (model info + reconstruction shape)
#
# Runs on the card; DEMO_DEVICE=cpu runs every stage on the CPU.
# DEMO_EXPERIMENT selects the config (default chest_base_vae_quick; use
# multi_modal_cvae_quick or disentangled_multi_modal_cvae_quick for a
# modality-aware analyze stage). Extra args pass through to the train CLI.
set -euo pipefail
cd "$(dirname "$0")/.."

EXP=${DEMO_EXPERIMENT:-chest_base_vae_quick}
LOGS=${DEMO_LOG_DIR:-$PWD/logs/demo_torch}
DEVICE=${DEMO_DEVICE:-cuda}
CKPT="$LOGS/checkpoints/$EXP/last"

echo "=== [1/6] model forward smoke ==="
DEVICE="$DEVICE" python - <<'PY'
import os
import torch
from medvae_tpu_torch.models import BaseVAE
device = torch.device(os.environ["DEVICE"])
model = BaseVAE(input_channels=1, latent_dim=16, hidden_channels=32,
                ch_mult=(1, 2, 4), num_res_blocks=1, attn_resolutions=(),
                resolution=28).to(device).eval()
x = torch.zeros((4, 28, 28, 1), device=device)
with torch.no_grad():
    out = model(x, generator=torch.Generator(device).manual_seed(2))
assert out["reconstruction"].shape == x.shape
print("forward ok:", {k: tuple(v.shape) for k, v in out.items()})
PY

echo "=== [2/6] 5-epoch quick training ($EXP) ==="
python -m medvae_tpu_torch.cli.train "experiment=$EXP" "device=$DEVICE" \
    training.max_epochs=5 "log_dir=$LOGS" early_stopping.enabled=false "$@"

echo "=== [3/6] generate ==="
python -m medvae_tpu_torch.cli.generate --model_path "$CKPT" --device "$DEVICE" \
    --num_samples 16 --output_dir "$LOGS/generate"

echo "=== [4/6] evaluate ==="
python -m medvae_tpu_torch.cli.evaluate --model_path "$CKPT" --device "$DEVICE" \
    --output_dir "$LOGS/evaluate" --max_batches 4

echo "=== [5/6] analyze latent space ==="
python -m medvae_tpu_torch.cli.analyze --model_path "$CKPT" --device "$DEVICE" \
    --output_dir "$LOGS/analyze" --samples_per_modality 64

echo "=== [6/6] serve round-trip ==="
LOGS="$LOGS" CKPT="$CKPT" DEVICE="$DEVICE" python - <<'PY'
import json, os, threading, urllib.request
import numpy as np
from medvae_tpu_torch.serve import InferenceEngine
from medvae_tpu_torch.cli.serve import serve, _np_to_b64, _b64_to_np

ckpt, logs = os.environ["CKPT"], os.environ["LOGS"]
eng = InferenceEngine.from_checkpoint(ckpt, buckets=(1, 4), device=os.environ["DEVICE"])
httpd = serve(eng, port=0, warmup=False)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
base = f"http://127.0.0.1:{httpd.server_address[1]}"
info = json.load(urllib.request.urlopen(base + "/info", timeout=120))
size = int(info.get("resolution", 28))
c = int(info.get("input_channels", 1))
imgs = np.zeros((2, size, size, c), np.uint8)
req = urllib.request.Request(
    base + "/reconstruct",
    json.dumps({"images_b64": _np_to_b64(imgs)}).encode(),
    {"Content-Type": "application/json"},
)
rec = _b64_to_np(json.load(urllib.request.urlopen(req, timeout=600))["images_b64"])
httpd.shutdown(); httpd.server_close()
with open(os.path.join(logs, "serve.json"), "w") as f:
    json.dump({"info": info, "reconstruction_shape": list(rec.shape)}, f, indent=2)
print("serve round-trip ok:", info.get("model"), "->", rec.shape)
PY

echo "=== demo complete; artifacts under $LOGS ==="
