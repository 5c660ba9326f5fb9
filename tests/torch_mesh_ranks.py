"""Rank functions of the compiled sharded rounds' tests
(``tests/test_torch_mesh_graph.py``). ``mesh.spawn_agents`` children import
this module by name, so it imports no JAX (nor anything that does)."""
import contextlib
import dataclasses

from test_torch_graph import CaptureWitness
from x_multi_agent_torch.parallel import dryrun
from x_multi_agent_torch.parallel import mesh as pmesh
from x_multi_agent_torch.utils import graph, tree


@contextlib.contextmanager
def witnessing(found: dict):
    """Every graph of a compiled program (``utils/graph.py``; on the CPU
    its body runs as a function) after its first call under a
    ``CaptureWitness``: ``found[name]`` lists what the witness found in
    graph ``name`` (empty: witnessed and clean)."""
    call, seen = graph._Graph.__call__, set()

    def watched(self, device):
        if id(self) not in seen:
            seen.add(id(self))
            return call(self, device)
        with CaptureWitness() as w:
            out = call(self, device)
        found.setdefault(self.name, []).extend(w.found)
        return out

    graph._Graph.__call__ = watched
    try:
        yield
    finally:
        graph._Graph.__call__ = call


def twin_rounds_rank(mesh, params, n_calls, fs, ccfg=None, dccfg=None, words=None, slots=None,
                     db=None):
    """Rank function: this rank's blocks of the full stacks (given on every
    rank) through ``n_calls`` calls of the compiled rounds, then from the
    same start through their plain twins (``compiled=False``); a call is
    the descriptor round under ``dccfg`` (when given), then the full-map
    round under ``ccfg`` (when given) on its result, as
    ``dryrun.sharded_rounds`` runs them. The compiled graphs run under
    :func:`witnessing`. Each twin ships on its own copy of the mesh, so
    each counts its own bytes. Every rank returns {"found": ...}; rank 0
    also {"compiled": [per call {"desc": ..., "full": ...}], "eager": [...]}
    (outputs gathered in agent order) and {"shipped": {twin: [per rank]}}."""
    sl = mesh.block(fs.cov.shape[0])
    blocks = [None if x is None else tree.map_leaves(lambda v: v[sl].to(mesh.device), x)
              for x in (fs, slots, db)]
    words = None if words is None else words.to(mesh.device)
    found, out, shipped = {}, {}, {}
    for mode in ("compiled", "eager"):
        twin = dataclasses.replace(mesh, shipped={})
        c = mode == "compiled"
        desc = None if dccfg is None else pmesh.sharded_collab_round_desc(params, dccfg, words,
                                                                          twin, compiled=c)
        full = None if ccfg is None else pmesh.sharded_collab_round(params, ccfg, twin,
                                                                     compiled=c)
        f, s, d = blocks
        calls = []
        with witnessing(found) if c else contextlib.nullcontext():
            for _ in range(n_calls):
                got = {}
                if desc is not None:
                    got["desc"] = desc(f, s, d)
                    f, d = got["desc"][:2]
                if full is not None:
                    got["full"] = full(f)
                    f = got["full"][0]
                calls.append({k: pmesh.gather_blocks(mesh, v) for k, v in got.items()})
        out[mode] = calls
        shipped[mode] = dryrun._gather_shipped(twin)
    dryrun._no_jax()
    return {"found": found} if mesh.rank else {"found": found, **out, "shipped": shipped}
