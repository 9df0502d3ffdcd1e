"""PyTorch/CUDA port of bmhrl_tpu for NVIDIA Hopper: caption serving
(greedy, beam search and sampling; ``serve.CaptionServer`` and the CLIs
``cli.serve_captions`` and ``cli.single_video``, with weights from a
reference ``.pt`` or from the port's own checkpoints,
``utils.checkpoint``) of the bimodal hierarchical captioner (BMHRL), its
unimodal ablations (AHRL, VHRL) and the DETR captioner
(``models.detr``), and their training (the steps
``train.steps.StepFactory`` and ``train.steps_detr.DetrStepFactory``, the
loop ``train.loop.train_rl_cap``, run by the CLIs ``cli.run_training`` and
``cli.synthetic_proof``; the critic's pretraining, ``cli.train_critic``),
and dense captioning's first stage: the event-proposal generator
(``models.proposal.MultimodalProposalGenerator``), trained by
``cli.train_proposals`` (``train.steps_proposal.ProposalStepFactory``)
and served with the captioner by ``cli.dense_caption`` (propose segments,
then caption them). ``serve_export`` exports a captioner's decode as
``torch.export`` programs (a bundle) that ``ExportedCaptionServer`` serves
without the model code.

The JAX package ``bmhrl_tpu`` is the reference and is never imported here.
Entry points take a ``device`` argument: ``"cuda"`` by default (an error
when no card is present), ``"cpu"`` for the plain PyTorch versions of the
kernels, as the tests use."""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` of ``device`` (a CUDA device with its index); raises
    for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
