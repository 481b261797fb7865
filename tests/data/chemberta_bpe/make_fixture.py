"""Writes the RoBERTa byte-level BPE fixture beside this file: vocab.json,
merges.txt, tokenizer_config.json and special_tokens_map.json, trained
with ``tokenizers.ByteLevelBPETokenizer`` on the SMILES of the repo's
synthetic dataset (mmdti_tpu_torch.finetune.make_synthetic_dataset, 400
molecules, seed 0) and of tests/conftest.py's SMILES_20.

    python tests/data/chemberta_bpe/make_fixture.py

Needs ``tokenizers``; the files it writes need nothing to be read.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
VOCAB_SIZE = 320   # at most: the 256 bytes, the 5 specials, merges seen twice or more
MODEL_MAX_LENGTH = 512


def main():
    sys.path.insert(0, REPO)
    from tokenizers import ByteLevelBPETokenizer

    from mmdti_tpu_torch.data.reader import read_csv
    from mmdti_tpu_torch.finetune import make_synthetic_dataset
    from tests.conftest import SMILES_20

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synthetic.csv")
        make_synthetic_dataset(data, n=400, seed=0)
        smiles = list(read_csv(data)["smiles"]) + list(SMILES_20)
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(smiles, vocab_size=VOCAB_SIZE, min_frequency=2,
                            special_tokens=SPECIALS)
    tok.save_model(HERE)
    mask = {"content": "<mask>", "lstrip": True, "normalized": False, "rstrip": False,
            "single_word": False, "special": True}
    specials = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                "sep_token": "</s>", "pad_token": "<pad>", "cls_token": "<s>",
                "mask_token": mask}
    config = {"tokenizer_class": "RobertaTokenizer", "model_max_length": MODEL_MAX_LENGTH,
              "add_prefix_space": False, "errors": "replace", **specials}
    for name, obj in (("tokenizer_config.json", config), ("special_tokens_map.json", specials)):
        with open(os.path.join(HERE, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
