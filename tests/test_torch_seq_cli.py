"""Each sequential model through the port's CLI on the CPU, over a tiny TSV
directory (``--data_dir <root> --dataset toy`` reads
``<root>/sequential/toy/{train,test}.tsv``): two epochs at a small width,
finite losses, the results artifact, and the eval's item width
``item_num + 1``."""

import json
import math

import pytest
import torch

from sslrec_tpu_torch import main as tmain
from test_torch_seq_data import write_seq_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

SMALL = ["--set", "model.embedding_size=16", "--set", "model.max_seq_len=10",
         "--set", "model.n_layers=1", "--set", "train.batch_size=16",
         "--set", "train.save_model=false"]
PER_MODEL = {"iclrec": ["--set", "model.num_intent_clusters=4"],
             "dcrec_seq": ["--set", "model.sim_group_k=2"],
             "maerec": ["--set", "model.con_batch=8", "--set", "model.num_reco_neg=4",
                        "--set", "model.num_mask_cand=5", "--set", "model.mask_steps=2",
                        "--set", "model.num_trm_layers=1"]}


@pytest.mark.parametrize("name", ["bert4rec", "cl4srec", "duorec", "iclrec", "dcrec_seq",
                                  "maerec"])
def test_cli_trains_and_evaluates_on_cpu(tmp_path, monkeypatch, name):
    write_seq_dir(tmp_path)
    monkeypatch.chdir(tmp_path)     # the logger writes ./log
    res = tmp_path / "res"
    trainer = tmain.main(["--model", name, "--data_dir", str(tmp_path), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2",
                          "--set", f"train.results_dir={res}", *SMALL,
                          *PER_MODEL.get(name, [])])
    doc = json.loads((res / f"{name}_toy.json").read_text())
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(math.isfinite(v) for v in r["loss"].values())
        assert r["eval_users"] == 40
    assert len(doc["test"]["recall"]) == 3
    user_emb, item_emb = trainer.model.generate()
    assert item_emb.shape == (trainer.data.item_num + 1, user_emb.shape[1])
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
