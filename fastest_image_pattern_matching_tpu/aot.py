"""AOT-exported match programs — deployment cold-start elimination.

A JIT library pays trace + lower + compile on every fresh process's first
call (the reference, a desktop C++ app, pays this at build time instead).
This module freezes the full match pipeline for a (pattern, config,
source-shape) triple to one portable pack file via `jax.export`:

  * `export_match_pack` — trace/lower once (e.g. on the deployment
    machine at install time) and serialize the StableHLO program(s),
    the learned pattern, and the config into a single .npz pack.
  * `AotMatcher.load` — fresh processes skip Python tracing entirely;
    with the persistent compile cache warm (tools/prewarm_cache.py),
    the first match pays only cache deserialization.

The pack also carries the batched serving programs (match_many buckets)
so a server restart reaches its steady-state latency on the first batch.
(Reference analogue: QSettings persists the UI's parameters across runs,
src/MatchToolDialog.cpp:495-561 — here the persisted artifact is the
compiled pipeline itself, the part an accelerator library actually needs.)

SECURITY — packs are code. A pack exported with include_executables=True
bundles pickled compiled executables, and loading it runs pickle.loads
(arbitrary code execution for a malicious file). Even without
executables, a pack's StableHLO programs are executed as-is. Only load
packs from trusted sources — treat a pack file exactly like a shared
library you would dlopen. Loaders verify format, not provenance; the
trust decision is the caller's.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import MatchConfig
from .types import LearnedPattern, MatchResult
from .models import template_matcher as _tm
from .models import batch as _batch

_FORMAT_VERSION = 1


def _cfg_to_json(cfg: MatchConfig) -> str:
    d = dataclasses.asdict(cfg)
    return json.dumps(d)


def _cfg_from_json(s: str) -> MatchConfig:
    d = json.loads(s)
    if d.get("tolerance_ranges") is not None:
        d["tolerance_ranges"] = tuple(d["tolerance_ranges"])
    return MatchConfig(**d)


def _export_fn(fn, args) -> bytes:
    """The portable StableHLO blob of fn. jax.export serializes with the
    optional flatbuffers package; without it this raises, and only an
    executables-only pack (portable=False) can be written."""
    from jax import export as jexport
    exported = jexport.export(fn)(*args)
    try:
        return exported.serialize()
    except ImportError as e:
        raise ImportError(
            f"{e} — or export with include_executables=True, "
            "portable=False for a pack of bundled executables only") from e


def _serialize_compiled(fn, args) -> Optional[bytes]:
    """Pickle the COMPILED executable (jax.experimental
    .serialize_executable) — the load side then skips the whole XLA
    pipeline, paying only executable upload + first run. Best-effort:
    returns None when the backend's executable serializer rejects the
    program (observed on XLA:CPU for sort comparators: "`LessThan` is
    not serializable"); the pack then ships the portable blob only."""
    import pickle
    from jax.experimental import serialize_executable as se
    try:
        comp = fn.lower(*args).compile()
        blob, in_tree, out_tree = se.serialize(comp)
        return pickle.dumps((blob, in_tree, out_tree))
    except Exception as e:
        import logging
        logging.getLogger(__name__).warning(
            "executable bundling skipped: %r", e)
        return None


def _program_blobs(fn, args, portable: bool, include_executables: bool):
    """(portable blob, bundled executable) of one program; either may be
    None, both may not: a pack must be able to run every program."""
    blob = _export_fn(fn, args) if portable else None
    exe = _serialize_compiled(fn, args) if include_executables else None
    if blob is None and exe is None:
        raise RuntimeError(
            "executable could not be bundled and portable=False: the pack "
            "would hold no runnable program")
    return blob, exe


def _check_pack_kind(portable: bool, include_executables: bool) -> bool:
    """Validate the export options; returns include_executables as it
    applies on this machine (bundling needs exactly one device)."""
    if include_executables and not _exe_bundling_ok():
        if not portable:
            raise ValueError("an executables-only pack (portable=False) "
                             "needs exactly one visible device")
        return False
    if not (portable or include_executables):
        raise ValueError("portable=False needs include_executables=True")
    return include_executables


def export_match_pack(path: str, pattern: LearnedPattern, cfg: MatchConfig,
                      src_shape: Tuple[int, int],
                      batch_sizes: Sequence[int] = (),
                      include_executables: bool = False,
                      portable: bool = True,
                      log=None) -> Dict[str, float]:
    """Export the compiled match program(s) for one deployment config.

    src_shape: (H, W) of the inspection frames this pack serves.
    batch_sizes: additional match_many bucket sizes to export (each is
    one more program; a server typically wants its steady batch, e.g. 8).
    include_executables: additionally bundle the fully-compiled
    executables for THIS machine's backend (VERDICT round-3 item 8 —
    first match then skips compile-from-persistent-cache entirely;
    executables are platform+topology specific, unlike the portable
    StableHLO blobs, and the loader falls back to those on mismatch).
    portable: write the portable StableHLO blobs (needs the flatbuffers
    package). portable=False, with include_executables=True on a
    single-device machine, writes a pack of bundled executables only:
    it loads only where its executables run, and fails loudly elsewhere.

    Returns per-program export seconds (diagnostics).
    """
    include_executables = _check_pack_kind(portable, include_executables)
    src_shape = (int(src_shape[0]), int(src_shape[1]))
    dummy = jax.ShapeDtypeStruct(src_shape, jnp.float32)
    plan, ekey, args = _prepare_abstract(pattern, cfg, src_shape)
    import time
    timings: Dict[str, float] = {}
    blobs: Dict[str, Optional[bytes]] = {}
    exe_blobs: Dict[str, Optional[bytes]] = {}
    programs = [("single", _tm._compiled(_tm._shared_plan(plan), ekey),
                 dummy)]
    if plan.nms_cap < plan.c_max:
        plan_full = dataclasses.replace(plan, nms_cap=plan.c_max)
        programs.append(("single_uncapped", _tm._compiled(
            _tm._shared_plan(plan_full), ekey), dummy))
    for b in sorted(set(int(b) for b in batch_sizes)):
        programs.append((f"batch_{b}", _batch._compiled_batch(
            _tm._shared_plan(plan), ekey, b),
            jax.ShapeDtypeStruct((b,) + src_shape, jnp.float32)))
    for name, fn, src_spec in programs:
        t0 = time.perf_counter()
        blobs[name], exe_blobs[name] = _program_blobs(
            fn, (src_spec,) + args[1:], portable, include_executables)
        timings[name] = time.perf_counter() - t0

    pat_buf = io.BytesIO()
    pattern.save(pat_buf)
    arrs = {
        "format_version": np.int64(_FORMAT_VERSION),
        "jax_version": np.frombuffer(jax.__version__.encode(), np.uint8),
        "platforms": np.frombuffer(
            json.dumps(_platforms_of(blobs["single"])).encode(), np.uint8),
        "cfg_json": np.frombuffer(_cfg_to_json(cfg).encode(), np.uint8),
        "src_shape": np.asarray(src_shape, np.int64),
        "pattern_npz": np.frombuffer(pat_buf.getvalue(), np.uint8),
    }
    _finish_pack(path, arrs, blobs, exe_blobs, "pack", log)
    return timings


def _platforms_of(blob: Optional[bytes]) -> List[str]:
    """The platforms a program runs on: its portable blob's, or this
    machine's for an executables-only pack."""
    if blob is None:
        return [_current_platform()]
    from jax import export as jexport
    return list(jexport.deserialize(blob).platforms)


def _load_exe(raw: bytes):
    import pickle
    from jax.experimental import serialize_executable as se
    blob, in_tree, out_tree = pickle.loads(raw)
    return se.deserialize_and_load(blob, in_tree, out_tree)


class _LazyFn:
    """Per-program lazy loader: packs can hold several programs (single,
    uncapped, batch buckets) whose executables are tens of MB each;
    extraction + inflate + deserialize happen on FIRST USE of each
    program, not at AotMatcher.load (the npz entries are read lazily —
    holding the NpzFile, not pre-extracted bytes, is what makes load
    O(metadata)) — with fallback from the bundled executable to the
    portable StableHLO blob on any error, including a first CALL that
    fails on a deserialized-but-incompatible executable. An
    executables-only pack has no blob to fall back to: its errors
    propagate."""

    __slots__ = ("_npz", "_exe_key", "_exp_key", "_fn", "_from_exe",
                 "_name")

    def __init__(self, name: str, npz, exe_key, exp_key):
        self._name = name
        self._npz = npz
        self._exe_key = exe_key
        self._exp_key = exp_key
        self._fn = None
        self._from_exe = False

    def _load_portable(self, cause=None):
        if self._exp_key is None:
            raise RuntimeError(
                f"pack program {self._name!r} has no portable blob and its "
                "bundled executable cannot run here — re-export on this "
                "machine") from cause
        from jax import export as jexport
        return jax.jit(jexport.deserialize(
            bytes(self._npz[self._exp_key])).call)

    def _resolve(self):
        if self._fn is None:
            cause = None
            if self._exe_key is not None:
                try:
                    self._fn = _load_exe(bytes(self._npz[self._exe_key]))
                    self._from_exe = True
                except Exception as e:
                    cause = e
                    import logging
                    logging.getLogger(__name__).warning(
                        "bundled executable %s unusable (%r); recompiling",
                        self._name, e)
            if self._fn is None:
                self._fn = self._load_portable(cause)
        return self._fn

    def __call__(self, *args):
        try:
            return self._resolve()(*args)
        except Exception as e:
            if not self._from_exe:
                raise
            # Executable deserialized but cannot execute here (e.g. pack
            # copied to a same-named but incompatible host): drop to the
            # portable program once.
            import logging
            logging.getLogger(__name__).warning(
                "bundled executable %s failed at call time (%r); "
                "recompiling from the portable program", self._name, e)
            self._fn = self._load_portable(e)
            self._from_exe = False
            return self._fn(*args)



def _finish_pack(path, arrs, blobs, exe_blobs, label, log):
    """Shared tail of both exporters: list the programs, attach their
    portable blobs (where serialized) and bundled executables, write the
    compressed npz, log the uncompressed size."""
    arrs["programs"] = np.frombuffer(json.dumps(list(blobs)).encode(),
                                     np.uint8)
    for name, blob in blobs.items():
        if blob is not None:
            arrs[f"exp_{name}"] = np.frombuffer(blob, np.uint8)
    n_programs = len(blobs)
    exe_blobs = {k: v for k, v in exe_blobs.items() if v is not None}
    if exe_blobs:
        arrs["exe_backend"] = np.frombuffer(
            _current_platform().encode(), np.uint8)
        for name, blob in exe_blobs.items():
            arrs[f"exe_{name}"] = np.frombuffer(blob, np.uint8)
    with open(path, "wb") as f:
        # Compressed: executables/StableHLO deflate ~5x; np.load
        # decompresses lazily per entry, pairing with _LazyFn so only
        # the programs actually used pay the inflate cost.
        np.savez_compressed(f, **arrs)
    if log:
        log(f"{label} {path}: "
            f"{sum(np.asarray(v).nbytes for v in arrs.values())/1e6:.2f} MB "
            f"uncompressed, programs={n_programs}")


def _current_platform() -> str:
    """This process's platform under the names jax.export uses ("cpu",
    "cuda", "rocm") — jax.default_backend() says "gpu" instead."""
    from jax import export as jexport
    return jexport.default_export_platform()


def _check_platform(platforms: Sequence[str], current: Optional[str] = None):
    """Refuse a pack whose programs were lowered for other platforms."""
    current = current or _current_platform()
    if current not in platforms:
        raise ValueError(
            f"pack was exported for {list(platforms)}, current platform is "
            f"{current!r} — re-export on this platform")


def _load_pack_fns(data):
    """Shared loader loop: one _LazyFn per exported program, preferring
    the bundled executable when the platform matches (single-device).
    Refuses a pack holding a program that can run neither way here."""
    exe_platform = (bytes(data["exe_backend"]).decode()
                    if "exe_backend" in data.files else None)
    use_exe = (exe_platform == _current_platform()
               and _exe_bundling_ok())
    if "programs" in data.files:
        names = json.loads(bytes(data["programs"]).decode())
    else:
        names = [k[4:] for k in data.files if k.startswith("exp_")]
    fns = {}
    for name in names:
        exe_key = (f"exe_{name}"
                   if use_exe and f"exe_{name}" in data.files else None)
        exp_key = f"exp_{name}" if f"exp_{name}" in data.files else None
        if exe_key is None and exp_key is None:
            raise ValueError(
                f"pack program {name!r} has no portable blob and no bundled "
                f"executable for this machine (executables are for "
                f"{exe_platform!r} on one device; this is "
                f"{_current_platform()!r} with {len(jax.devices())}) — "
                "re-export on this machine")
        fns[name] = _LazyFn(name, data, exe_key, exp_key)
    return fns


def _exe_bundling_ok() -> bool:
    """Bundled executables are single-device artifacts: jax's
    serialize_executable mis-assigns devices under a multi-device client
    (observed: 'expected args to have 8 shards' on a forced 8-device CPU
    mesh), so both export and load gate on exactly one visible device —
    the deployment topology packs target anyway."""
    return len(jax.devices()) == 1


def _prepare_abstract(pattern: LearnedPattern, cfg: MatchConfig, src_shape):
    """The _prepare arg construction for a shape-only source."""
    plan = _tm._make_plan(src_shape, pattern, cfg)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pattern.levels)
    templs = _tm._get_pattern_dev(pattern)
    tstats = _tm._traced_stats_tuple(stats)
    ekey = _tm._stats_key(stats)
    args = (None, templs, tstats) + _tm._plan_device_arrays(plan) \
        + (_tm._thr_dev(plan.layer_scores),)
    return plan, ekey, args


class AotMatcher:
    """A match pipeline loaded from an exported pack — no tracing.

    Usage:
        m = AotMatcher.load("line3.fipm-aot.npz")
        results = m.match(frame)              # [H, W] u8/f32
        batches = m.match_many(frames)        # [B, H, W], exported buckets
    """

    def __init__(self, pattern: LearnedPattern, cfg: MatchConfig,
                 src_shape: Tuple[int, int], fns: Dict[str, object],
                 platforms: List[str]):
        self.pattern = pattern
        self.config = cfg
        self.src_shape = src_shape
        self.platforms = platforms
        self._fns = fns  # name -> jitted exported call
        self._args_tail = None  # cached (templs, tstats, plan arrays)

    @classmethod
    def load(cls, path: str) -> "AotMatcher":
        data = np.load(path)
        ver = int(data["format_version"])
        if ver != _FORMAT_VERSION:
            raise ValueError(f"unsupported pack version {ver}")
        if "kind" in data.files and bytes(data["kind"]) != b"match":
            raise ValueError(
                f"{path} is a {bytes(data['kind']).decode()!r} pack, not a "
                "match pack (use AotOrb.load for ORB packs)")
        cfg = _cfg_from_json(bytes(data["cfg_json"]).decode())
        src_shape = tuple(int(v) for v in data["src_shape"])
        pattern = LearnedPattern.load(io.BytesIO(bytes(data["pattern_npz"])))
        platforms = json.loads(bytes(data["platforms"]).decode())
        _check_platform(platforms)
        # Bundled executables (include_executables=True at export): load
        # them directly and skip the XLA pipeline entirely; fall back to
        # the portable StableHLO blobs on platform mismatch or any error.
        fns = _load_pack_fns(data)
        return cls(pattern, cfg, src_shape, fns, platforms)

    @property
    def batch_sizes(self) -> List[int]:
        return sorted(int(k.split("_")[1]) for k in self._fns
                      if k.startswith("batch_"))

    def _tail(self):
        if self._args_tail is None:
            _plan, _ekey, args = _prepare_abstract(
                self.pattern, self.config, self.src_shape)
            self._args_tail = args[1:]
        return self._args_tail

    def _to_device(self, src, batched: bool = False) -> jnp.ndarray:
        if not isinstance(src, jnp.ndarray):
            src = np.asarray(src)
            if src.ndim == 3 + batched:  # trailing channel axis
                from .utils.imageio import ensure_gray
                src = ensure_gray(src)
            if src.dtype != np.uint8:
                lo, hi = float(src.min()), float(src.max())
                if lo < 0.0 or hi > 255.0:
                    raise ValueError(
                        f"source values must lie in [0, 255], got "
                        f"[{lo}, {hi}]")
            src = jnp.asarray(src, jnp.float32)
        if src.dtype != jnp.float32:
            src = src.astype(jnp.float32)
        return src

    def match_arrays(self, src) -> Dict[str, np.ndarray]:
        src = self._to_device(src)
        if tuple(src.shape) != self.src_shape:
            raise ValueError(f"pack serves frames of shape {self.src_shape},"
                             f" got {tuple(src.shape)}")
        out = _tm._unpack_result(self._fns["single"](src, *self._tail()))
        if out.pop("nms_overflow", False):
            fn2 = self._fns.get("single_uncapped")
            if fn2 is not None:
                out = _tm._unpack_result(fn2(src, *self._tail()))
                out.pop("nms_overflow", None)
            else:
                # No uncapped program in the pack (cap == candidate count
                # at export time): fall back to the traced path.
                out = _tm.match_arrays(src, self.pattern, self.config)
                out.pop("nms_overflow", None)
        return out

    def match(self, src) -> List[MatchResult]:
        out = self.match_arrays(src)
        wrapped = {k: v[None] for k, v in out.items()}
        return _batch._results_from_arrays(wrapped, 0, self.pattern)

    def match_many(self, srcs) -> List[List[MatchResult]]:
        srcs = self._to_device(srcs, batched=True)
        if srcs.ndim != 3 or tuple(srcs.shape[1:]) != self.src_shape:
            raise ValueError(
                f"srcs must be [B, {self.src_shape[0]}, {self.src_shape[1]}]"
                f", got {tuple(srcs.shape)}")
        B = srcs.shape[0]
        buckets = [b for b in self.batch_sizes if b >= B]
        if not buckets:
            raise ValueError(
                f"no exported batch program fits B={B} "
                f"(exported buckets: {self.batch_sizes})")
        b = buckets[0]
        if b > B:
            srcs = jnp.pad(srcs, ((0, b - B), (0, 0), (0, 0)))
        packed = np.asarray(self._fns[f"batch_{b}"](srcs, *self._tail()))
        results = []
        for i in range(B):
            out = _tm._unpack_result(packed[i])
            if out.pop("nms_overflow", False):
                out = self.match_arrays(srcs[i])
            else:
                out.pop("nms_overflow", None)
            wrapped = {k: v[None] for k, v in out.items()}
            results.append(_batch._results_from_arrays(wrapped, 0,
                                                       self.pattern))
        return results


# ---------------------------------------------------------------------------
# ORB AOT packs — serving parity for the secondary matcher.
# The reference's ORB path is an interactive rerun-per-pair desktop flow
# (ORBMatch/ORBFeatureMatcher.cpp:21-201); a matching service instead freezes
# the whole detect/match/RANSAC program per (config, shapes) so a fresh
# process skips tracing, exactly like the NCC packs above.


def export_orb_pack(path: str, cfg, src_shape: Tuple[int, int],
                    templ_shape: Tuple[int, int],
                    batch_sizes: Sequence[int] = (), seed: int = 0,
                    include_executables: bool = False,
                    portable: bool = True,
                    log=None) -> Dict[str, float]:
    """Export the compiled ORB pipeline for fixed source/template shapes.

    batch_sizes: orb_match_many bucket sizes to additionally export
    (template described once, B sources matched in one program).
    include_executables, portable: as in export_match_pack."""
    from .models import orb as _orb
    import time
    cfg = cfg or _orb.ORBConfig()
    src_shape = (int(src_shape[0]), int(src_shape[1]))
    templ_shape = (int(templ_shape[0]), int(templ_shape[1]))
    dummy_s = jax.ShapeDtypeStruct(src_shape, jnp.float32)
    dummy_t = jax.ShapeDtypeStruct(templ_shape, jnp.float32)

    include_executables = _check_pack_kind(portable, include_executables)
    timings: Dict[str, float] = {}
    blobs: Dict[str, Optional[bytes]] = {}
    exe_blobs: Dict[str, Optional[bytes]] = {}
    programs = [("single", _orb._orb_core(cfg, seed), dummy_s)]
    for b in sorted(set(int(b) for b in batch_sizes)):
        programs.append((f"batch_{b}", _orb._orb_core_many(cfg, seed),
                         jax.ShapeDtypeStruct((b,) + src_shape, jnp.float32)))
    for name, fn, src_spec in programs:
        t0 = time.perf_counter()
        blobs[name], exe_blobs[name] = _program_blobs(
            fn, (src_spec, dummy_t), portable, include_executables)
        timings[name] = time.perf_counter() - t0

    arrs = {
        "format_version": np.int64(_FORMAT_VERSION),
        "kind": np.frombuffer(b"orb", np.uint8),
        "jax_version": np.frombuffer(jax.__version__.encode(), np.uint8),
        "platforms": np.frombuffer(
            json.dumps(_platforms_of(blobs["single"])).encode(), np.uint8),
        "cfg_json": np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8),
        "seed": np.int64(seed),
        "src_shape": np.asarray(src_shape, np.int64),
        "templ_shape": np.asarray(templ_shape, np.int64),
    }
    _finish_pack(path, arrs, blobs, exe_blobs, "orb pack", log)
    return timings


class AotOrb:
    """ORB pipeline loaded from an exported pack — no tracing.

    Usage:
        m = AotOrb.load("orb.fipm-aot.npz")
        res = m.match(source, template)         # ORBResult
        res_list = m.match_many(sources, template)
    """

    def __init__(self, cfg, seed: int, src_shape, templ_shape, fns,
                 platforms):
        self.config = cfg
        self.seed = seed
        self.src_shape = src_shape
        self.templ_shape = templ_shape
        self.platforms = platforms
        self._fns = fns

    @classmethod
    def load(cls, path: str) -> "AotOrb":
        from .models.orb import ORBConfig
        data = np.load(path)
        ver = int(data["format_version"])
        if ver != _FORMAT_VERSION:
            raise ValueError(f"unsupported pack version {ver}")
        if "kind" not in data.files or bytes(data["kind"]) != b"orb":
            raise ValueError(f"{path} is not an ORB pack")
        cfg = ORBConfig(**json.loads(bytes(data["cfg_json"]).decode()))
        src_shape = tuple(int(v) for v in data["src_shape"])
        templ_shape = tuple(int(v) for v in data["templ_shape"])
        platforms = json.loads(bytes(data["platforms"]).decode())
        _check_platform(platforms)
        fns = _load_pack_fns(data)
        return cls(cfg, int(data["seed"]), src_shape, templ_shape, fns,
                   platforms)

    @property
    def batch_sizes(self) -> List[int]:
        return sorted(int(k.split("_")[1]) for k in self._fns
                      if k.startswith("batch_"))

    def _check(self, source, templ):
        from .utils.imageio import ensure_gray
        source = np.asarray(source)
        templ = np.asarray(templ)
        if source.ndim == len(self.src_shape) + 1:
            source = ensure_gray(source)
        if templ.ndim == 3:
            templ = ensure_gray(templ)
        if tuple(templ.shape) != self.templ_shape:
            raise ValueError(f"pack serves templates of shape "
                             f"{self.templ_shape}, got {templ.shape}")
        return source, templ

    def match(self, source, template, physics_shift_mm: float = 8.0):
        from .models.orb import _result_from_packed
        source, template = self._check(source, template)
        if tuple(source.shape) != self.src_shape:
            raise ValueError(f"pack serves frames of shape {self.src_shape},"
                             f" got {source.shape}")
        packed = np.asarray(self._fns["single"](
            jnp.asarray(source, jnp.float32),
            jnp.asarray(template, jnp.float32)))
        return _result_from_packed(packed, template.shape, physics_shift_mm)

    def match_many(self, sources, template, physics_shift_mm: float = 8.0):
        from .models.orb import _result_from_packed
        sources = np.asarray(sources)
        if sources.ndim == 4:
            from .utils.imageio import ensure_gray
            sources = ensure_gray(sources)
        _, template = self._check(np.zeros(self.src_shape, np.uint8),
                                  template)
        if sources.ndim != 3 or tuple(sources.shape[1:]) != self.src_shape:
            raise ValueError(
                f"sources must be [B, {self.src_shape[0]}, "
                f"{self.src_shape[1]}], got {tuple(sources.shape)}")
        B = sources.shape[0]
        buckets = [b for b in self.batch_sizes if b >= B]
        if not buckets:
            raise ValueError(f"no exported batch program fits B={B} "
                             f"(exported buckets: {self.batch_sizes})")
        b = buckets[0]
        srcs = np.pad(sources.astype(np.float32),
                      ((0, b - B), (0, 0), (0, 0)))
        packed = np.asarray(self._fns[f"batch_{b}"](
            jnp.asarray(srcs), jnp.asarray(template, jnp.float32)))
        return [_result_from_packed(packed[i], template.shape,
                                    physics_shift_mm) for i in range(B)]
