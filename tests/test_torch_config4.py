"""Configuration 4's single-card modules on the CPU at log n = 8:
`snark_tpu_torch/config4_e2e.py` (the counterpart of
`scripts/run_config4_e2e.py`: setup, two proves and the verify of
MulChain(4, 2^8 − 64), m = 386) and
`snark_tpu_torch/config4_shards.py` (`scripts/run_config4_shards.py`: the
shard MSM and the six-step local stage). Oracles: the pairing check, the
64-point pool's MSM, `ntt_rows_plain`.
"""

import json

import pytest
import torch

from snark_tpu_torch import config4_e2e, config4_shards


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_config4_e2e_cpu(tmp_path, capsys):
    """The setup (want_query=False: its vectors below 2048 points keep
    their legacy query arrays, as the reference's do), a cold and a warm
    prove and the verify, a JSON line a stage and the final record; with
    --pk the key is saved, and a second run loads it."""
    path = str(tmp_path / "pk.npz")
    assert config4_e2e.main(["--log-n", "8", "--pk", path, "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("stage") for x in lines] == ["setup", "prove_cold", "prove_warm", "verify",
                                                None]
    rec = lines[-1]
    assert rec["verified"] is True and rec["constraints"] == 192 and rec["domain"] == 256
    assert rec["host_max_rss_bytes"] > 0
    assert "pk_save_s" in rec and "synthesize" in lines[0]["stage_ms"]
    again = config4_e2e.run(8, path, setup_only=True, device="cpu", emit=lambda _: None)
    assert again["setup_only"] and "pk_load_s" in again


def test_config4_shards_cpu():
    """2^8 over two modelled cards at c = 8: the shard MSM of 128 points
    equals the pool oracle, the local stage's first row its plain version."""
    rec = config4_shards.run(8, 2, 8, 1, "cpu")
    assert rec["msm_correct"] and rec["ntt_correct"]
    assert (rec["shard_points"], rec["ntt_local_rows"], rec["ntt_local_len"]) == (128, 8, 16)
    with pytest.raises(ValueError):
        config4_shards.run(8, 3, 8, 1, "cpu")
