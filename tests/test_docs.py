"""Docs-vs-artifacts consistency: no doc or module cites a record that is
no longer in the repository (the per-round bench JSONs, the judge notes,
the round scripts under benchmarks/)."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = ["BASELINE.md", "PARITY.md", "README.md", "CLAUDE.md", "PERF.md"]
DELETED = re.compile(r"BENCH_r\d+|MULTICHIP_r\d+|VERDICT|ADVICE|"
                     r"benchmarks/|gen_baseline")


def _cites(path):
    with open(path) as f:
        return sorted(set(DELETED.findall(f.read())))


@pytest.mark.parametrize("doc", DOCS)
def test_doc_cites_no_deleted_record(doc):
    path = os.path.join(REPO, doc)
    assert os.path.exists(path), doc
    assert not _cites(path), f"{doc} cites {_cites(path)}"


def test_code_cites_no_deleted_record():
    bad = []
    for root, _, files in os.walk(REPO):
        if any(p in root for p in (".git", "chiprun_out", ".jax_cache")):
            continue
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                if _cites(path) and name != "test_docs.py":
                    bad.append(f"{os.path.relpath(path, REPO)}: "
                               f"{_cites(path)}")
    assert not bad, "; ".join(bad)
