"""Roofline share of the critic's cells, ``bmhrl::lstm_cell_packed`` and
``bmhrl::gru_cell_packed`` together: their calls' least time over the
device time under the two ops."""
from benchmark import roofline


def read(ctx):
    calls = ([(roofline.lstm_cell_s(s), t) for s, t in
              ctx.trace.ops.get("bmhrl::lstm_cell_packed", [])]
             + [(roofline.gru_cell_s(s), t) for s, t in
                ctx.trace.ops.get("bmhrl::gru_cell_packed", [])])
    device = sum(t for _, t in calls)
    return 100.0 * sum(b for b, _ in calls) / device if device > 0 else None
