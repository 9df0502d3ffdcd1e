"""Special-token convention of the training vocabulary (torchtext order):
<unk>=0, <blank>=1 (pad), <s>=2, </s>=3."""
UNK, PAD, BOS, EOS = 0, 1, 2, 3
SPECIALS = ["<unk>", "<blank>", "<s>", "</s>"]
