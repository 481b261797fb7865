"""The CPU accuracy guard of the port: the twin of
tests/test_protocol_guard.py::TestAccuracySmoke::test_tiny_protocol_learns
for mmdti_tpu_torch.finetune.  One seed of the synthetic scaffold protocol
(160 molecules, the same tiny architecture, 4 epochs, batch 16, fp32, the
plain path as the JAX guard takes its XLA path) on the CPU with torch on
one thread, held to the JAX guard's ceiling: a broken learning signal
(loss wiring, scaler, featurization, optimizer) scores about the target's
spread (~1.25) and fails it.
"""

import torch

from mmdti_tpu_torch import finetune as ft
from tests.test_protocol_guard import SMOKE_RMSE_CEILING
from tests.torch_task_parity import one_thread


def test_tiny_protocol_learns(tmp_path):
    threads = one_thread()
    try:
        data = str(tmp_path / "smoke.csv")
        ft.make_synthetic_dataset(data, n=160)
        rmse = ft.run_seed(
            data, 0, str(tmp_path), epochs=4, early_stopping=4, batch_size=16,
            arch=dict(
                unimol_overrides={"encoder_layers": 2, "embed_dim": 32,
                                  "ffn_embed_dim": 64, "attention_heads": 4},
                chemberta_overrides={"hidden_size": 32, "num_hidden_layers": 1,
                                     "num_attention_heads": 2, "intermediate_size": 64},
            ),
            path_overrides={"compute_dtype": "float32", "use_pallas": False}, device="cpu",
        )
    finally:
        torch.set_num_threads(threads)
    print(f"port accuracy smoke RMSE {rmse:.4f} (ceiling {SMOKE_RMSE_CEILING})")
    assert rmse < SMOKE_RMSE_CEILING, (
        f"accuracy smoke RMSE {rmse:.4f} regressed past {SMOKE_RMSE_CEILING} "
        "(no-learning scores ~1.25 on this dataset)")
