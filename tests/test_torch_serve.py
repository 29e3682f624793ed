"""The port's serving driver (``repro_torch.launch.serve_retrieval``) end to
end on the CPU at a reduced width: encode, build, search with ``plaid``, and
the vanilla ColBERTv2 comparison that ``examples/serve_retrieval.py``
prints (ms per query, PLAID's speedup, top-1 agreement)."""
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.launch import serve_retrieval  # noqa: E402


def test_serve_retrieval_prints_the_vanilla_comparison(capsys):
    assert serve_retrieval.main(["--device", "cpu", "--docs", "300"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^plaid k=10 B<=32: p50 [0-9.]+ ms/batch", out, re.M), out
    m = re.search(r"^vanilla: ([0-9.]+) ms/q -> PLAID speedup ([0-9.]+)x, "
                  r"top-1 agreement ([0-9]+)%$", out, re.M)
    assert m, out
    assert float(m.group(1)) > 0 and float(m.group(2)) > 0
    assert 0.0 <= int(m.group(3)) / 100 <= 1.0
    assert "not ported" not in out
