"""The port's ``single_video`` CLI against the JAX package's, on the CPU,
from one reference ``.pt`` at the dims both always build (Config's): the
sentence must be identical (f32, so the decoded tokens are), greedy and
beam W=2 over a cropped segment."""
import json

import pytest
from test_torch_port_entry import corpus  # noqa: F401 (module fixture)
from torch_port_common import jax_kernels
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu.utils import checkpoint as jckpt
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data import vocab
from bmhrl_tpu_torch.weights import random_jax_layout_params


@pytest.fixture(scope="module")
def flagship_pt(corpus, tmp_path_factory):
    """A reference .pt at the dims single_video always builds (Config's),
    the corpus's vocabulary, random weights, written by the JAX export."""
    voc = len(vocab.build_vocab_from_tsv(corpus["train"]))
    tree = random_jax_layout_params(Config().agent_kwargs(voc), seed=5)
    path = str(tmp_path_factory.mktemp("pt") / "flagship.pt")
    jckpt.export_torch_bmhrl(tree["params"], path)
    return path


@pytest.mark.parametrize("extra", [[], ["--beam_width", "2", "--start", "1",
                                        "--end", "8", "--duration", "12"]],
                         ids=["greedy", "beam2_cropped"])
def test_single_video_cli_matches_jax(corpus, flagship_pt, extra):
    from bmhrl_tpu_torch.cli.single_video import main
    from cli.single_video import main as jmain


    vid = sorted(json.load(open(corpus["ref"])))[1]
    vdir, adir = corpus["video_features_path"], corpus["audio_features_path"]
    args = ["--rgb", f"{vdir}/{vid}_rgb.npy", "--flow",
            f"{vdir}/{vid}_flow.npy", "--audio", f"{adir}/{vid}.npy",
            "--train_meta_path", corpus["train"], "--torch_checkpoint",
            flagship_pt, "--compute_dtype", "float32", "--max_len", "6"]
    got = main(args + extra + ["--device", "cpu"])
    with jax_kernels(flash=True, folded=True):
        want = jmain(args + extra)
    assert isinstance(got, str) and got == want
