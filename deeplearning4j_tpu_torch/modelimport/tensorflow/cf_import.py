"""TF control-flow import: counterpart of
``deeplearning4j_tpu/modelimport/tensorflow/cf_import.py`` (:1-788):
TF1 frames, TF2 functional ops and TensorArrays, on the port's
``autodiff/control_flow.py`` (``while_loop``, ``if_cond``,
``case_graph``, ``call_graph``).

- **TF1 frames** (Enter/Merge/Switch/NextIteration/Exit/LoopCond): the
  frame structure is rebuilt statically (:func:`plan_v1_frames`); every
  node gets a frame path by a dataflow fixpoint (Enter pushes, Exit
  pops); each top-level frame's Merges are the loop variables, the
  condition is cut between the Merges and LoopCond, the body between
  Switch:1 and NextIteration, and the frame becomes ONE ``while_loop``
  op, with ``max_trip_count`` where the trip count derives statically
  (``derive_trip_count``: a bounded loop trains). Nested frames recurse
  through the body's own import.
- **TF1 cond** (Switch/Merge without frames): Switch forwards its input
  to both branch edges tagged with (pred, branch); Merge finds the pred
  on which its inputs differ and emits ``where(pred, true, false)``;
  both arms compute. ``_SwitchN`` (a lowered Case) selects by an
  equality chain.
- **TF2 functional ops** (While/If/Case/PartitionedCall and the
  Stateless forms): the FunctionDef bodies import into sub-graphs
  (:func:`import_function`).
- **TensorArrays** (TensorArray*V3, TensorList*): a dense ``(size,
  *elem)`` tensor carried as loop state (``ops/tensor_array.py``).

Where JAX reads an op's output arguments from TF's OpDef registry and
copies nodes with protobuf, the port reads ``graphdef_wire``'s table and
copies its own :class:`NodeDef`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport.tensorflow.graphdef_wire import (
    output_arg_offset,
)
from deeplearning4j_tpu_torch.modelimport.tensorflow.tf_import import (
    OpMappingRegistry, TFImportError, _Walker, _is_dyn,
)


def _init_const(walker: "_Walker", ref: str):
    """Import-time constant value of a loop-init tensor ref, or None.
    Feeds derive_trip_count so counter-bounded frames lower to the
    differentiable masked-scan form of while_loop. Partials are only
    usable if they carry NO dynamic sentinel — including the
    provenance-tagged ones below DYN itself (_is_dyn, not == DYN):
    a shape-derived bound from a dynamic dim must fall back to the
    lax.while_loop lowering, not become a bogus constant."""
    src, idx = _Walker.resolve(ref)
    if idx != 0:
        return None
    v = walker.const_vals.get(src)
    if v is not None and getattr(v, "dtype", None) is not None \
            and v.dtype.kind not in "OSU":
        return v
    p = walker.partials.get(src)
    if p is not None and not np.any(_is_dyn(p)):
        return p
    return None

_LOOP_OPS = {"Enter", "RefEnter", "Exit", "RefExit", "NextIteration",
             "RefNextIteration", "LoopCond"}
_MISSING = object()


# ------------------------------------------------------------ frame paths
def _frame_paths(nodes: Sequence[Any]) -> Dict[str, Tuple[str, ...]]:
    """Frame path per node (outermost-first tuple of frame names),
    mirroring the TF executor's frame semantics: Enter pushes its
    frame_name, Exit pops, everything else inherits the deepest known
    predecessor path (predecessors outside this node set count as
    root). Fixpoint iteration handles the NextIteration back edge."""
    by_name = {n.name: n for n in nodes}
    paths: Dict[str, Tuple[str, ...]] = {}

    def pred_names(n) -> List[str]:
        out = []
        for ref in n.input:
            r = ref[1:] if ref.startswith("^") else ref
            out.append(_Walker.resolve(r)[0])
        return out

    changed = True
    while changed:
        changed = False
        for n in nodes:
            preds = []
            unknown = False
            for src in pred_names(n):
                if src not in by_name:
                    preds.append(())
                elif src in paths:
                    preds.append(paths[src])
                else:
                    unknown = True
            if unknown and not preds:
                continue
            base = max(preds, key=len) if preds else ()
            if n.op in ("Enter", "RefEnter"):
                fname = n.attr["frame_name"].s.decode()
                path = base + (fname,)
            elif n.op in ("Exit", "RefExit"):
                path = base[:-1]
            else:
                path = base
            if paths.get(n.name) != path:
                paths[n.name] = path
                changed = True
    for n in nodes:
        paths.setdefault(n.name, ())
    return paths


class _FramePlan:
    """One reconstructed TF1 while frame → one while_loop op."""

    def __init__(self, name: str, merged: List[Dict[str, Any]],
                 invariant: List[Any], loopcond: Any,
                 pool: Dict[str, Any]):
        self.name = name
        self.merged = merged       # {enter, merge, switch, next} nodes
        self.invariant = invariant  # Enter nodes without a Merge
        self.loopcond = loopcond
        self.pool = pool           # frame-interior nodes by name

    def emit(self, walker: _Walker) -> Tuple[Any, ...]:
        n_m = len(self.merged)
        cond_boundary: Dict[str, int] = {}
        body_boundary: Dict[str, int] = {}
        for i, mv in enumerate(self.merged):
            for k in (mv["merge"].name, mv["merge"].name + ":0"):
                cond_boundary[k] = i
            body_boundary[mv["switch"].name + ":1"] = i
        for j, en in enumerate(self.invariant):
            for k in (en.name, en.name + ":0"):
                cond_boundary[k] = n_m + j
                body_boundary[k] = n_m + j
        init_vars = [walker.lookup(mv["enter"].input[0])
                     for mv in self.merged] + \
                    [walker.lookup(en.input[0]) for en in self.invariant]
        # loop-var shapes are loop-invariant, so init avals ARE the
        # in-loop avals — they drive shape folding inside cond/body
        arg_avals = [walker.avals.get(v.name) for v in init_vars]
        cond_graph = build_subgraph(
            walker, self.pool, cond_boundary, [self.loopcond.input[0]],
            arg_avals=arg_avals)
        body_outputs = [mv["next"].input[0] for mv in self.merged] + \
                       [en.name for en in self.invariant]
        body_graph = build_subgraph(
            walker, self.pool, body_boundary, body_outputs,
            arg_avals=arg_avals)
        inits = [v.name for v in init_vars]
        from deeplearning4j_tpu_torch.autodiff.control_flow import (
            derive_trip_count,
        )
        init_consts = [_init_const(walker, mv["enter"].input[0])
                       for mv in self.merged] + \
                      [_init_const(walker, en.input[0])
                       for en in self.invariant]
        out = walker.sd._op(
            "while_loop", inits, n_out=n_m + len(self.invariant),
            name=self.name, cond_graph=cond_graph, body_graph=body_graph,
            max_trip_count=derive_trip_count(cond_graph, body_graph,
                                             init_consts))
        out = out if isinstance(out, tuple) else (out,)
        # loop-carried shapes are invariant: output avals = init avals,
        # so downstream shape folding keeps working past the loop
        for v, av in zip(out, arg_avals):
            if av is not None:
                walker.avals[v.name] = av
        return out


def plan_v1_frames(walker: _Walker, nodes: Sequence[Any]):
    """Detect TF1 while frames in `nodes`. Returns (skip set of node
    names consumed by frames, exit-node map name -> (frame, var idx),
    frame plans by frame name)."""
    if not any(n.op in ("Enter", "RefEnter") for n in nodes):
        return set(), {}, {}
    paths = _frame_paths(nodes)
    by_name = {n.name: n for n in nodes}

    skip: Set[str] = {n.name for n in nodes if paths[n.name]}
    exit_map: Dict[str, Tuple[str, int]] = {}
    plans: Dict[str, _FramePlan] = {}

    top_frames = {paths[n.name][0] for n in nodes
                  if n.op in ("Enter", "RefEnter")
                  and len(paths[n.name]) == 1}
    for fname in sorted(top_frames):
        fpath = (fname,)
        enters = [n for n in nodes if n.op in ("Enter", "RefEnter")
                  and paths[n.name] == fpath]
        enter_names = {n.name for n in enters}
        merges = [n for n in nodes
                  if n.op in ("Merge", "RefMerge")
                  and paths[n.name] == fpath
                  and any(_Walker.resolve(r)[0] in enter_names
                          for r in n.input)]
        loopconds = [n for n in nodes if n.op == "LoopCond"
                     and paths[n.name] == fpath]
        if len(loopconds) != 1 or not merges:
            raise TFImportError(
                f"cannot reconstruct while frame {fname!r}: "
                f"{len(loopconds)} LoopCond nodes, {len(merges)} "
                "loop-variable Merges")
        merge_names = {n.name for n in merges}
        switch_by_merge: Dict[str, Any] = {}
        for n in nodes:
            if n.op in ("Switch", "RefSwitch") and paths[n.name] == fpath:
                src = _Walker.resolve(n.input[0])[0]
                if src in merge_names:
                    switch_by_merge[src] = n
        merged: List[Dict[str, Any]] = []
        for m in merges:
            ins = {by_name[_Walker.resolve(r)[0]].op:
                   by_name[_Walker.resolve(r)[0]] for r in m.input}
            enter = next((by_name[_Walker.resolve(r)[0]] for r in m.input
                          if _Walker.resolve(r)[0] in enter_names), None)
            nxt = next((by_name[_Walker.resolve(r)[0]] for r in m.input
                        if by_name[_Walker.resolve(r)[0]].op in
                        ("NextIteration", "RefNextIteration")), None)
            sw = switch_by_merge.get(m.name)
            if enter is None or nxt is None or sw is None:
                raise TFImportError(
                    f"while frame {fname!r}: loop var {m.name!r} missing "
                    f"Enter/NextIteration/Switch "
                    f"(got {sorted(ins)})")
            merged.append({"enter": enter, "merge": m, "switch": sw,
                           "next": nxt})
        merged_enter_names = {mv["enter"].name for mv in merged}
        invariant = [n for n in enters
                     if n.name not in merged_enter_names]
        machinery = (enter_names | merge_names |
                     {mv["switch"].name for mv in merged} |
                     {mv["next"].name for mv in merged} |
                     {loopconds[0].name})
        pool = {n.name: n for n in nodes
                if paths[n.name][:1] == fpath
                and n.name not in machinery}
        # inner-frame Exits pop back to this frame's path and belong to
        # the body pool; this frame's own Exits map to loop outputs
        switch_names = {mv["switch"].name: i
                        for i, mv in enumerate(merged)}
        for n in nodes:
            if n.op in ("Exit", "RefExit"):
                src, idx = _Walker.resolve(n.input[0])
                if src in switch_names and idx == 0:
                    exit_map[n.name] = (fname, switch_names[src])
                    skip.add(n.name)
                elif paths[n.name][:1] == fpath:
                    pool[n.name] = n
        plans[fname] = _FramePlan(fname, merged, invariant,
                                  loopconds[0], pool)
    # Execution accounting: the frame machinery ops are CONSUMED by this
    # reconstruction rather than dispatched through OpMappingRegistry —
    # record them here so the mapper gate sees the path that handles
    # them actually ran (body ops record normally via build_subgraph's
    # walk).
    from deeplearning4j_tpu_torch.modelimport import trace as mapper_trace
    machinery_ops = _LOOP_OPS | {"Merge", "RefMerge", "Switch",
                                 "RefSwitch"}
    for n in nodes:
        if n.name in exit_map or (paths[n.name]
                                  and n.op in machinery_ops):
            mapper_trace.record("tf", n.op)
    return skip, exit_map, plans


# --------------------------------------------------------- subgraph build
def _topo_collect(walker: _Walker, pool: Dict[str, Any],
                  boundary_keys: Set[str], outputs: Sequence[str],
                  allow_outer_consts: bool = True) -> List[Any]:
    """DFS-topo the node subset needed for `outputs`, stopping at
    boundary tensors; outer constants (loop-invariant consts the TF
    graph didn't Enter) may be pulled in. Frame-aware: an inner while
    frame is a legitimate CYCLE (the NextIteration back edge), so its
    member set is collected as one unit — external deps first, then
    every member — and the sub-walk's own plan_v1_frames reconstructs
    it recursively."""
    order: List[Any] = []
    done: Set[str] = set()
    onpath: Set[str] = set()
    fpaths = _frame_paths(list(pool.values())) \
        if any(n.op in ("Enter", "RefEnter") for n in pool.values()) \
        else {}
    frames_done: Set[str] = set()

    def key_of(ref: str) -> Tuple[str, str]:
        src, idx = _Walker.resolve(ref)
        return (f"{src}:{idx}" if idx else src), src

    def dep_srcs(node, extra_skip: Set[str] = frozenset()) -> List[str]:
        out = []
        for ref in node.input:
            if ref.startswith("^"):
                continue
            k, src = key_of(ref)
            if k in boundary_keys or f"{src}:0" in boundary_keys \
                    or src in extra_skip:
                continue
            out.append(src)
        return out

    # explicit stack (a whole model behind one PartitionedCall can
    # chain thousands of nodes — Python recursion would blow up):
    # ("node", name) expands deps, ("exit", node) emits postorder,
    # ("frame", members) emits a whole while frame as one unit
    stack: List[Tuple[str, Any]] = []
    for ref in reversed(list(outputs)):
        k, src = key_of(ref)
        if k not in boundary_keys:
            stack.append(("node", src))
    while stack:
        kind, payload = stack.pop()
        if kind == "exit":
            node = payload
            onpath.discard(node.name)
            if node.name not in done:
                done.add(node.name)
                order.append(node)
            continue
        if kind == "frame":
            for m in payload:
                if m.name not in done:
                    done.add(m.name)
                    order.append(m)
            continue
        name = payload
        if name in done:
            continue
        if name in onpath:
            raise TFImportError(
                f"cycle through {name!r} in control-flow subgraph "
                "(unreconstructed back edge)")
        p = fpaths.get(name, ())
        if p:
            fname = p[0]
            if fname in frames_done:
                continue
            frames_done.add(fname)
            members = [n for n in pool.values()
                       if fpaths.get(n.name, ())[:1] == (fname,)]
            member_names = {n.name for n in members}
            stack.append(("frame", members))
            for m in members:
                for src in reversed(dep_srcs(m, member_names)):
                    stack.append(("node", src))
            continue
        node = pool.get(name)
        if node is None:
            outer = walker.nodes_by_name.get(name) \
                if allow_outer_consts else None
            if outer is not None and outer.op == "Const":
                node = outer
            else:
                raise TFImportError(
                    f"control-flow subgraph references {name!r}, which "
                    "is neither inside the frame/function nor a "
                    "constant")
        onpath.add(name)
        stack.append(("exit", node))
        for src in reversed(dep_srcs(node)):
            stack.append(("node", src))
    return order


def build_subgraph(walker: _Walker, pool: Dict[str, Any],
                   boundary: Dict[str, int], outputs: Sequence[str],
                   allow_outer_consts: bool = True,
                   arg_avals: Sequence[Any] = ()) -> Dict[str, Any]:
    """Import a node subset as a serialized sub-graph dict whose inputs
    are the boundary tensors (arg order by boundary index). arg_avals
    (probe-aval pairs per arg, from the caller's scope) let shape
    folding and dynamic-index detection work inside the sub-graph."""
    from deeplearning4j_tpu_torch.autodiff.control_flow import (
        ARG_PREFIX, subgraph_to_dict,
    )
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.modelimport.tensorflow.tf_import import (
        _PartialEval,
    )

    # built on the CPU: the dict keeps numpy arrays, which the op puts on
    # its own device when it runs
    sub = SameDiff(device="cpu")
    w = _Walker(sub, library=walker.library, pe=_PartialEval())
    n_in = (max(boundary.values()) + 1) if boundary else 0
    phs: Dict[int, Any] = {}
    for key, i in sorted(boundary.items(), key=lambda kv: kv[1]):
        if i not in phs:
            phs[i] = sub.placeholder(f"{ARG_PREFIX}{i}")
            if i < len(arg_avals) and arg_avals[i] is not None:
                w.avals[phs[i].name] = arg_avals[i]
        w.tensors[key] = phs[i]
    order = _topo_collect(walker, pool, set(boundary), outputs,
                          allow_outer_consts)
    w.walk(order)
    out_names = [phs[boundary[ref]].name if ref in boundary
                 else w.lookup(ref).name for ref in outputs]
    return subgraph_to_dict(sub, out_names, n_in)


# ----------------------------------------------------- functional (TF2)
def _out_arg_offset(node, out_name: str) -> int:
    """Overall output index offset of a named OpDef output arg
    (FunctionDef refs are `node:out_arg:k`, where k indexes WITHIN the
    named arg — multi-output ops need the preceding args' sizes); from
    ``graphdef_wire.OUTPUT_ARGS``, where TF's OpDef registry serves
    JAX."""
    return output_arg_offset(node, out_name)


def import_function(walker: _Walker, fname: str, n_args: int,
                    arg_avals: Sequence[Any] = ()) -> Dict[str, Any]:
    """FunctionDef → sub-graph dict with args as boundary inputs."""
    fdef = walker.library.get(fname)
    if fdef is None:
        raise TFImportError(
            f"function {fname!r} not found in the graph library")
    sig = fdef.signature
    if len(sig.input_arg) != n_args:
        raise TFImportError(
            f"function {fname!r} takes {len(sig.input_arg)} args, "
            f"caller passes {n_args}")
    nodes_raw = {nd.name: nd for nd in fdef.node_def}

    def norm(ref: str) -> str:
        if ref.startswith("^"):
            return ref
        parts = ref.split(":")
        if len(parts) == 1:
            return ref
        if len(parts) == 2:
            # 'node:out' index-0 shorthand (older serializations);
            # 'node:3' is already normalized
            try:
                int(parts[1])
                return ref
            except ValueError:
                parts = [parts[0], parts[1], "0"]
        name, out_name, idx = parts[0], parts[1], int(parts[2])
        nd = nodes_raw.get(name)
        if nd is None:
            raise TFImportError(
                f"function {fname!r}: ref {ref!r} to unknown node")
        k = _out_arg_offset(nd, out_name) + idx
        return f"{name}:{k}" if k else name

    pool: Dict[str, Any] = {}
    nodes: List[Any] = []
    for nd in fdef.node_def:
        c = nd.copy()
        for i, ref in enumerate(c.input):
            c.input[i] = norm(ref)
        pool[c.name] = c
        nodes.append(c)
    boundary: Dict[str, int] = {}
    for i, a in enumerate(sig.input_arg):
        boundary[a.name] = i
        boundary[f"{a.name}:0"] = i
    outputs = [norm(fdef.ret[oa.name]) for oa in sig.output_arg]
    return build_subgraph(walker, pool, boundary, outputs,
                          allow_outer_consts=False, arg_avals=arg_avals)


# --------------------------------------------- walker-level op handlers
def _map_multi(walker: _Walker, node, out) -> None:
    out = out if isinstance(out, tuple) else (out,)
    for k, v in enumerate(out):
        walker.tensors[f"{node.name}:{k}"] = v
    walker.tensors[node.name] = out[0]


def _w_switch(walker: _Walker, node, in_vars, in_refs) -> None:
    """v1 Switch → both output edges alias the input, tagged with the
    branch; selection happens at the matching Merge."""
    data, pred = in_vars[0], in_vars[1]
    walker.pred_kinds[pred.name] = "bool"
    tags = walker._gather_tags(node)
    for key, b in ((node.name, False), (node.name + ":0", False),
                   (node.name + ":1", True)):
        walker.tensors[key] = data
        t = dict(tags)
        t[pred.name] = b
        walker.branch_tags[key] = t


def _w_switchn(walker: _Walker, node, in_vars, in_refs) -> None:
    """_SwitchN (the lowered form of Case): N output edges alias the
    input, each tagged with its integer branch index; the N-way Merge
    selects with an eq-chain."""
    data, index = in_vars[0], in_vars[1]
    walker.pred_kinds[index.name] = "int"
    n_out = int(node.attr["num_outs"].i)
    tags = walker._gather_tags(node)
    walker.tensors[node.name] = data
    for k in range(n_out):
        walker.tensors[f"{node.name}:{k}"] = data
        t = dict(tags)
        t[index.name] = k
        walker.branch_tags[f"{node.name}:{k}"] = t
    walker.branch_tags[node.name] = dict(walker.branch_tags
                                         [node.name + ":0"])


def _w_merge(walker: _Walker, node, in_vars, in_refs) -> None:
    """v1 Merge → where(pred, true_branch, false_branch), or an
    eq-chain select for an N-way _SwitchN merge. All arms were
    computed (dead-branch values exist but are discarded — the same
    all-arms-compiled semantics lax.cond/switch have on TPU)."""
    keys = [f"{s}:{i}" if i else s for s, i in in_refs]
    if len(in_vars) != 2:
        _w_merge_n(walker, node, in_vars, keys)
        return
    ta = walker.branch_tags.get(keys[0], {})
    tb = walker.branch_tags.get(keys[1], {})
    both = [p for p in ta if p in tb and ta[p] != tb[p]]
    if len(both) == 1:
        p = both[0]
    elif both:
        raise TFImportError(
            f"{node.name}: Merge inputs differ on multiple predicates "
            f"{sorted(both)}; cannot reconstruct the cond")
    else:
        single = [p for p in set(ta) | set(tb) if (p in ta) != (p in tb)]
        if len(single) != 1:
            raise TFImportError(
                f"{node.name}: Merge inputs carry no usable branch "
                "tags (not a reconstructible v1 cond)")
        p = single[0]
    a_true = ta.get(p, not tb.get(p, False))
    t_var, f_var = (in_vars[0], in_vars[1]) if a_true \
        else (in_vars[1], in_vars[0])
    t_idx, f_idx = (0, 1) if a_true else (1, 0)
    sd = walker.sd
    out = sd._op("where", [p, t_var.name, f_var.name], name=node.name)
    ci = sd.constant(node.name + "/vi_t", np.int32(t_idx))
    cj = sd.constant(node.name + "/vi_f", np.int32(f_idx))
    vi = sd._op("where", [p, ci.name, cj.name],
                name=node.name + "/index")
    walker.tensors[node.name] = out
    walker.tensors[node.name + ":0"] = out
    walker.tensors[node.name + ":1"] = vi
    surviving: Dict[str, bool] = {}
    for q in set(ta) | set(tb):
        if q == p:
            continue
        if (q in ta) and (q in tb):
            if ta[q] == tb[q]:
                surviving[q] = ta[q]
        else:
            surviving[q] = ta.get(q, tb.get(q))
    if surviving:
        for key in (node.name, node.name + ":0"):
            walker.branch_tags[key] = dict(surviving)


def _w_merge_n(walker: _Walker, node, in_vars, keys) -> None:
    """N-way Merge over _SwitchN branches: every input must carry the
    same int-kind predicate with a distinct branch value; selection is
    a chain of where(index == k, branch_k, acc)."""
    tag_sets = [walker.branch_tags.get(k, {}) for k in keys]
    preds = [p for p in (set.intersection(*map(set, map(dict, tag_sets)))
                         if tag_sets else set())
             if walker.pred_kinds.get(p) == "int"
             and len({t[p] for t in tag_sets}) == len(tag_sets)]
    if len(preds) != 1:
        raise TFImportError(
            f"{node.name}: {len(in_vars)}-way Merge without a single "
            "distinguishing _SwitchN index (not a reconstructible "
            "Case lowering)")
    p = preds[0]
    sd = walker.sd
    out = in_vars[0]
    vi = sd.constant(f"{node.name}/vi0", np.int32(0))
    for j in range(1, len(in_vars)):
        kconst = sd.constant(f"{node.name}/k{j}",
                             np.int32(tag_sets[j][p]))
        cond = sd._op("eq", [p, kconst.name])
        out = sd._op("where", [cond.name, in_vars[j].name, out.name],
                     name=node.name if j == len(in_vars) - 1 else None)
        jc = sd.constant(f"{node.name}/vij{j}", np.int32(j))
        vi = sd._op("where", [cond.name, jc.name, vi.name],
                    name=(node.name + "/index")
                    if j == len(in_vars) - 1 else None)
    walker.tensors[node.name] = out
    walker.tensors[node.name + ":0"] = out
    walker.tensors[node.name + ":1"] = vi
    # surviving ENCLOSING tags (minus the resolved pred) propagate so a
    # Case nested inside another cond/Case keeps its outer context —
    # same rule as the 2-way merge
    surviving: Dict[str, Any] = {}
    for q in set().union(*map(set, tag_sets)):
        if q == p:
            continue
        vals = [t.get(q, _MISSING) for t in tag_sets]
        present = [v for v in vals if v is not _MISSING]
        if len(set(present)) == 1:
            surviving[q] = present[0]
    if surviving:
        for key in (node.name, node.name + ":0"):
            walker.branch_tags[key] = dict(surviving)


def _w_while(walker: _Walker, node, in_vars, in_refs) -> None:
    """TF2 functional While → while_loop over imported cond/body."""
    from deeplearning4j_tpu_torch.autodiff.control_flow import derive_trip_count

    n = len(in_vars)
    avs = [walker.avals.get(v.name) for v in in_vars]
    cond_g = import_function(walker, node.attr["cond"].func.name, n, avs)
    body_g = import_function(walker, node.attr["body"].func.name, n, avs)
    init_consts = [_init_const(walker, f"{s}:{i}" if i else s)
                   for s, i in in_refs]
    out = walker.sd._op(
        "while_loop", [v.name for v in in_vars], n_out=n,
        name=node.name, cond_graph=cond_g, body_graph=body_g,
        max_trip_count=derive_trip_count(cond_g, body_g, init_consts))
    _map_multi(walker, node, out)


def _w_if(walker: _Walker, node, in_vars, in_refs) -> None:
    """TF2 functional If → if_cond over imported branches."""
    then_name = node.attr["then_branch"].func.name
    else_name = node.attr["else_branch"].func.name
    n_args = len(in_vars) - 1
    avs = [walker.avals.get(v.name) for v in in_vars[1:]]
    tg = import_function(walker, then_name, n_args, avs)
    eg = import_function(walker, else_name, n_args, avs)
    n_out = len(walker.library[then_name].signature.output_arg)
    out = walker.sd._op(
        "if_cond", [v.name for v in in_vars], n_out=n_out,
        name=node.name, true_graph=tg, false_graph=eg)
    _map_multi(walker, node, out)


def _w_case(walker: _Walker, node, in_vars, in_refs) -> None:
    """TF2 functional Case → case_graph (lax.switch)."""
    fnames = [f.name for f in node.attr["branches"].list.func]
    n_args = len(in_vars) - 1
    avs = [walker.avals.get(v.name) for v in in_vars[1:]]
    graphs = [import_function(walker, fn, n_args, avs) for fn in fnames]
    n_out = len(walker.library[fnames[0]].signature.output_arg)
    out = walker.sd._op(
        "case_graph", [v.name for v in in_vars], n_out=n_out,
        name=node.name, branches=graphs)
    _map_multi(walker, node, out)


def _w_call(walker: _Walker, node, in_vars, in_refs) -> None:
    """PartitionedCall → inline the function body (call_graph traces it
    into the parent jit; the call boundary disappears)."""
    fname = node.attr["f"].func.name
    g = import_function(walker, fname, len(in_vars),
                        [walker.avals.get(v.name) for v in in_vars])
    n_out = len(walker.library[fname].signature.output_arg)
    out = walker.sd._op(
        "call_graph", [v.name for v in in_vars], n_out=n_out,
        name=node.name, graph=g)
    _map_multi(walker, node, out)


WALKER_OPS = {
    "Switch": _w_switch, "RefSwitch": _w_switch,
    "_SwitchN": _w_switchn,
    "Merge": _w_merge, "RefMerge": _w_merge,
    "While": _w_while, "StatelessWhile": _w_while,
    "If": _w_if, "StatelessIf": _w_if,
    "Case": _w_case, "StatelessCase": _w_case,
    "PartitionedCall": _w_call, "StatefulPartitionedCall": _w_call,
}


# ------------------------------------------------------------ TA mappers
def _register_control_flow_mappers():
    R = OpMappingRegistry.register

    for opn in sorted(_LOOP_OPS):
        def _loose(ctx, _o=opn):
            raise TFImportError(
                f"{ctx.node.name}: {_o} outside a reconstructible "
                "while frame (Enter/Merge/Switch structure not found)")
        R(opn)(_loose)

    @R("TensorArrayV3")
    def _ta_v3(ctx):
        size = int(ctx.static_np(0))
        eshape = ctx.attr("element_shape")
        dt = ctx.attr("dtype", "float32")
        handle = ctx.op("tf_fill", [], shape=[], value=0.0)
        if eshape and all(int(d) >= 0 for d in eshape):
            flow = ctx.op("tensorarray_reserve", [], size=size,
                          elem_shape=[int(d) for d in eshape], dtype=dt)
        else:
            # unknown element shape: 1-D dummy; a full scatter
            # (unstack) replaces it and defines the real shape
            flow = ctx.op("tensorarray_reserve", [], size=size,
                          elem_shape=[], dtype=dt)
        return (handle, flow)

    @R("TensorArrayReadV3")
    def _ta_read(ctx):
        return ctx.op("gather", [ctx.inputs[2], ctx.inputs[1]], axis=0)

    @R("TensorArrayWriteV3")
    def _ta_write(ctx):
        return ctx.op("tensorarray_write",
                      [ctx.inputs[3], ctx.inputs[1], ctx.inputs[2]])

    @R("TensorArrayScatterV3")
    def _ta_scatter(ctx):
        return ctx.op("tensorarray_scatter",
                      [ctx.inputs[3], ctx.inputs[1], ctx.inputs[2]])

    @R("TensorArrayGatherV3")
    def _ta_gather(ctx):
        return ctx.op("gather", [ctx.inputs[2], ctx.inputs[1]], axis=0)

    @R("TensorArraySizeV3")
    def _ta_size(ctx):
        return ctx.op("tensorarray_size", [ctx.inputs[1]])

    # ---- TF2 TensorList (v2 TensorArray), same dense representation
    @R("TensorListReserve")
    def _tl_reserve(ctx):
        num = int(ctx.static_np(1))
        dt = ctx.attr("element_dtype", "float32")
        es = np.atleast_1d(ctx.static_np(0))
        if es.size and np.all(es >= 0):
            return ctx.op("tensorarray_reserve", [], size=num,
                          elem_shape=[int(d) for d in es], dtype=dt)
        return ctx.op("tensorarray_reserve", [], size=num,
                      elem_shape=[], dtype=dt)

    @R("TensorListSetItem")
    def _tl_set(ctx):
        return ctx.op("tensorarray_write", ctx.inputs[:3])

    @R("TensorListGetItem")
    def _tl_get(ctx):
        return ctx.op("gather", ctx.inputs[:2], axis=0)

    @R("TensorListGather")
    def _tl_gather(ctx):
        return ctx.op("gather", ctx.inputs[:2], axis=0)

    @R("TensorListStack")
    def _tl_stack(ctx):
        return ctx.op("identity", ctx.inputs[:1])

    @R("TensorListFromTensor")
    def _tl_from(ctx):
        return ctx.op("identity", ctx.inputs[:1])

    @R("TensorListLength")
    def _tl_len(ctx):
        return ctx.op("tensorarray_size", ctx.inputs[:1])


_register_control_flow_mappers()
