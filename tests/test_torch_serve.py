"""The port's serving drivers on the CPU: ``repro_torch.launch.serve_retrieval``
end to end at a reduced width (encode, build, search with ``plaid``, and
the vanilla ColBERTv2 comparison that ``examples/serve_retrieval.py``
prints: ms per query, PLAID's speedup, top-1 agreement), and
``repro_torch.launch.serve`` against the reference's ``repro.launch.serve``
at a small ``--docs``."""
import re
import sys

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


# --------------------------------------------------------------------------
# launch/serve.py against the reference's driver (repro.launch.serve)
# --------------------------------------------------------------------------
SERVE_ARGV = ["--docs", "300", "--queries", "48", "--batch", "16", "--backend", "plaid",
              "--compare-vanilla", "--sweep-t-cs"]


def test_serve_driver_matches_the_reference_driver(monkeypatch, capsys):
    """The reference's driver and the port's on the same corpus and the
    same index (the reference's k-means draws its own samples, so the
    port's driver is handed the reference's index, carried across as
    numpy): the same pids and success@1 for ``plaid``, every sweep point
    and ``vanilla``, and the reference's lines in the same format."""
    import numpy as np
    from repro import retrieval as rret
    from repro.core import index as ri
    from repro.data import synthetic as rsyn
    from repro.launch import serve as rserve
    from repro_torch.core import index as ti
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", *SERVE_ARGV])
    rserve.main()
    want = capsys.readouterr().out.splitlines()
    docs, _ = rsyn.embedding_corpus(300, dim=128)
    ref_index = ri.build_index(docs, nbits=2)
    qs, gold = rsyn.queries_from_docs(docs, 48)
    carried = ti.index_from_numpy({f: np.asarray(getattr(ref_index, f)) for f in ti.ARRAY_FIELDS},
                                  {f: getattr(ref_index, f) for f in ti.STATIC_FIELDS},
                                  device="cpu")
    monkeypatch.setattr(serve.index_mod, "build_index", lambda *a, **kw: carried)
    lines = []
    got = serve.run(serve.parse_args([*SERVE_ARGV, "--device", "cpu"]), log=lines.append)

    def ref_pids(backend, params):
        r = rret.from_index(ref_index, backend=backend, params=params)
        return np.concatenate([np.asarray(r.search_batch(qs[i : i + 16]).pids)
                               for i in range(0, 48, 16)])

    np.testing.assert_array_equal(got["pids"], ref_pids("plaid", rret.params_for_k(10)))
    np.testing.assert_array_equal(got["gold"], gold)
    np.testing.assert_array_equal(got["vanilla"]["pids"], ref_pids("vanilla", rret.SearchParams(
        k=10, nprobe=4, candidate_cap=2**13, ndocs=4096)))
    # the same lines, numbers aside; success@1 printed identically
    pattern = re.compile(r"[0-9]+\.[0-9]+")
    assert [pattern.sub("#", x) for x in lines[1:-2]] == [pattern.sub("#", x) for x in want[1:-2]]
    for g, w in zip(lines[1:], want[1:]):
        if "success@1" in w:
            assert re.findall(r"success@1 ([0-9.]+)", g) == re.findall(r"success@1 ([0-9.]+)", w)
    assert [len(got["sweep"]), got["sweep_trace_count"]] == [4, 0]
    assert "eager PyTorch traces nothing" in lines[-2]
    assert lines[-1].startswith("vanilla k=10: mean ") and "-> plaid speedup " in lines[-1]
    assert got["vanilla"]["speedup"] > 0 and got["p99_ms"] >= got["p50_ms"] > 0
