"""The port's eval CLI against ``scripts/evaluate_real.py`` for the LGD
families of the released variants (without and with the init RNN, at 6 and
12 sensors; ``tests/test_torch_eval_cli.py`` has the others and the
helpers), and ``--cross_subject``. Same weights, asset tree and tolerance
(rtol 1e-4) as there.
"""

import pytest
import torch

from tests.test_released_configs import RELEASED_VARIANTS
from tests.test_torch_eval_cli import check_family, check_flag, experiments  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind, n_markers",
                         [v for v in RELEASED_VARIANTS if v[0].startswith("lgd")])
def test_cli_rows_match_jax_cli(experiments, capsys, kind, n_markers):  # noqa: F811
    check_family(experiments, capsys, kind, n_markers)


def test_cli_cross_subject(experiments, capsys):  # noqa: F811
    """--cross_subject: the hold-out recording, one row and the overall."""
    rows = check_flag(experiments, capsys, "lgd_rnn", "9201", ["--cross_subject"],
                      cross_subject=True)
    assert [r[0] for r in rows][-1] == "Overall average" and rows[0][0].startswith("0715")
