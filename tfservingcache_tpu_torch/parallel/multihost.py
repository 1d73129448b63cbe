"""Groups that span processes (counterpart of
``tfservingcache_tpu/parallel/multihost.py``): one model cut over members
that several processes own (``parallel/mesh.py``: each process holds its
own block of members, the others are meta placeholders).

Every process of such a group must run the same ops in the same order, each
entering the same collectives, but serving is request-driven and only one
process receives each request. So, as in the reference:

  - the group's LEADER (process 0, which owns member 0) is its ring member:
    it binds the group's REST/gRPC ports and answers requests;
  - every other process, a FOLLOWER, runs only the group-work service, a
    small HTTP endpoint (``GroupWorkServer``); before each collective op
    (load with its warm-up, predict, generate, unload) the leader sends the
    op and its full inputs to every follower, which replays it against its
    own cache manager and runtime, so that every process enters the same
    forward and its partials meet over ``torch.distributed``
    (``parallel.mesh.gather_members``);
  - the broadcast is FIRE-THEN-COMPUTE: the leader starts its own half
    while the followers run theirs (waiting for their answers first would
    deadlock the collective) and collects the answers after;
  - a lock on the leader serializes the group's ops, which is what gives
    every process the same op order; a follower runs its work items under
    a lock of its own.

Where the reference's collectives are XLA's inside one jitted program and
its rendezvous is ``jax.distributed``, the port's are ``torch.distributed``
all-gathers over the gloo backend (``server.build_node`` calls
``init_process_group`` first), issued by the tensor-parallel modules
themselves. The work envelope is the reference's byte format, so either
package decodes the other's.
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping

import numpy as np

from tfservingcache_tpu_torch.runtime.base import GroupUnhealthyError
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import ModelId

log = logging.getLogger("tpusc_torch.multihost")

WORK_PATH = "/tpusc/groupwork"
# unhealthy-group re-formation probe cadence (the leader pings the
# followers, then resets the whole group to an empty lockstep state)
REFORM_PROBE_PERIOD_S = 5.0
PING_TIMEOUT_S = 2.0
# bound on joining the work pool's threads at close (a wedged item keeps
# running past it; its thread is a daemon)
CLOSE_JOIN_S = 10.0
# the gloo process group's timeout: a rendezvous, and a collective whose
# peer is gone, fail after it (a follower's cold load may run this long
# before it enters the warm-up collective the leader waits in)
COLLECTIVE_TIMEOUT_S = 600.0


class FollowerUnreachable(RuntimeError):
    """Transport-level follower failure: connection refused or reset, or
    the work timeout: the process is dead or wedged, as opposed to a live
    follower answering 500 (an application error scoped to one request)."""


def encode_work(meta: dict, arrays: Mapping[str, np.ndarray] | None = None) -> bytes:
    """npz envelope: JSON meta + named tensors (no pickle: work requests
    cross a trust boundary between processes)."""
    buf = io.BytesIO()
    payload = {f"t_{k}": np.asarray(v) for k, v in (arrays or {}).items()}
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(buf, **payload)
    return buf.getvalue()


def decode_work(body: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        arrays = {k[2:]: z[k] for k in z.files if k.startswith("t_")}
    return meta, arrays


def join_process_group(coordinator: str, num_processes: int, process_id: int) -> None:
    """The rendezvous of a group that spans processes: the default
    ``torch.distributed`` process group over gloo (host tensors; a card's
    partials are staged through host memory by ``mesh.gather_members``), at
    ``tcp://<coordinator>``, with this process's rank ``process_id``. Every
    process of the group calls it before building anything else (the
    reference's ``jax.distributed.initialize``, server.py:88-111)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    log.info("joined the process group at %s as rank %d of %d", coordinator, process_id,
             num_processes)


def leave_process_group() -> None:
    """Destroy the default process group, if this process has one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class GroupWorkHandler:
    """Follower side: runs the ops the leaders of this process's groups
    send it."""

    def __init__(self) -> None:
        # group index -> (manager, runtime)
        self._groups: dict[int, tuple[Any, Any]] = {}
        self._locks: dict[int, threading.Lock] = {}
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="tpusc-gw")

    def register(self, group_index: int, manager, runtime) -> None:
        self._groups[group_index] = (manager, runtime)
        self._locks[group_index] = threading.Lock()

    @property
    def group_indexes(self) -> list[int]:
        return sorted(self._groups)

    def _execute(self, meta: dict, arrays: dict[str, np.ndarray],
                 t_arrival: float | None = None) -> None:
        gi = int(meta["group"])
        manager, runtime = self._groups[gi]
        op = meta["op"]
        # program-affecting config must match across the group: a mismatch
        # (prefix_cache_bytes on the leader, off here) would run DIFFERENT
        # ops into one collective. Checked on every envelope, ping
        # included, so a misconfigured group's re-formation stays blocked
        # with a clear error instead of churning teardown/re-form forever
        cfg = meta.get("cfg")
        if cfg is not None:
            mine = getattr(runtime, "_prefix_cache", None) is not None
            if bool(cfg.get("prefix_cache")) != mine:
                raise RuntimeError(
                    f"group {gi} config mismatch: leader prefix_cache="
                    f"{bool(cfg.get('prefix_cache'))}, this process={mine}: "
                    "serving.prefix_cache_bytes must match on every process "
                    "of a cross-host group"
                )
        if op == "ping":
            # re-formation probe: alive AND able to take the group lock soon;
            # a follower wedged mid-op answers "busy", so the leader keeps
            # the group down instead of re-forming against a stuck process
            lock = self._locks[gi]
            if not lock.acquire(timeout=float(meta.get("lock_timeout_s", 0.5))):
                raise TimeoutError("group lock busy (possibly wedged mid-op)")
            lock.release()
            return
        if op == "reset":
            with self._locks[gi]:
                runtime.reset_group_state()
            log.info("group %d state reset for re-formation", gi)
            return
        mid = ModelId(meta["model"], int(meta["version"]))
        with self._locks[gi]:  # the same-order guarantee as the leader's lock
            # the leader ships its remaining request budget: a PREFETCH that
            # spent it queued behind the group lock is one the leader has
            # abandoned (504), so it fails fast. ONLY this host-side phase
            # may be dropped: by the time a collective op (ensure, predict,
            # generate, unload) runs here the leader has entered its half,
            # and a skipped follower would strand it in the collective
            budget = meta.get("budget_s")
            if (op == "prefetch" and budget is not None and t_arrival is not None
                    and time.monotonic() - t_arrival > float(budget)):
                raise TimeoutError(
                    f"work item {op} for {mid} expired before execution "
                    f"(queued {time.monotonic() - t_arrival:.1f}s > "
                    f"budget {float(budget):.1f}s)"
                )
            if op == "prefetch":
                manager.prefetch(mid)  # host-side IO only, no collectives
            elif op == "ensure":
                manager.ensure_servable(mid)
            elif op == "predict":
                manager.ensure_servable(mid)
                runtime.predict(mid, arrays, meta.get("output_filter") or None)
            elif op == "generate":
                manager.ensure_servable(mid)
                draft_mid = (ModelId(meta["draft_model"], int(meta["draft_version"]))
                             if meta.get("draft_model") else None)
                if draft_mid is not None:
                    manager.ensure_servable(draft_mid)
                pr = meta.get("prefix_rows")
                runtime.generate(
                    mid,
                    arrays["input_ids"],
                    prompt_lengths=arrays["prompt_lengths"].tolist(),
                    max_new_tokens=int(meta["max_new_tokens"]),
                    temperature=float(meta["temperature"]),
                    top_k=int(meta["top_k"]),
                    seed=int(meta["seed"]),  # MUST match the leader's draw
                    draft_model_id=draft_mid,
                    spec_tokens=int(meta.get("spec_tokens", 4)),
                    # the leader's prefix-cache decision: this process runs
                    # the same ops (None = decide here, an older leader)
                    prefix_rows=None if pr is None else int(pr),
                    # the leader's draft gate admitted the draft it shipped:
                    # this process's own gate must not drop it
                    spec_admitted=True if draft_mid is not None else None,
                )
            elif op == "unload":
                runtime.unload(mid)
            else:
                raise ValueError(f"unknown group work op {op!r}")

    def handle(self, body: bytes, t_arrival: float | None = None) -> tuple[int, dict]:
        """One POST of ``WORK_PATH`` -> (HTTP status, JSON body): the item
        runs on the work pool; any failure answers 500 with its type and
        message, which the leader surfaces."""
        try:
            meta, arrays = decode_work(body)
            self._pool.submit(self._execute, meta, arrays, t_arrival).result()
        except Exception as e:  # noqa: BLE001 - errors go back to the leader
            log.exception("group work failed")
            return 500, {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return 200, {"ok": True}

    def close(self) -> None:
        """Shut the work pool down (queued items are cancelled) and join its
        threads within ``CLOSE_JOIN_S``."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + CLOSE_JOIN_S
        for t in list(self._pool._threads):
            t.join(timeout=max(0.0, deadline - time.monotonic()))


class _WorkHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128


class GroupWorkServer:
    """The follower process's work endpoint (one a process, shared by every
    group it follows), on the stdlib threading HTTP server as the port's
    REST server is."""

    def __init__(self, handler: GroupWorkHandler) -> None:
        self.handler = handler
        self.port = 0
        self._httpd: _WorkHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def _request_handler(self) -> type[BaseHTTPRequestHandler]:
        work = self.handler

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self) -> None:  # noqa: N802 - http.server's naming
                t_arrival = time.monotonic()
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                if self.path != WORK_PATH:
                    status, out = 404, {"ok": False, "error": f"no route {self.path}"}
                else:
                    status, out = work.handle(body, t_arrival)
                payload = json.dumps(out).encode()
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except OSError as e:
                    # the leader gave up on this item (its op timeout)
                    # and closed the connection
                    log.info("group work answer not delivered: %s", e)
                    self.close_connection = True

            def log_message(self, fmt: str, *args) -> None:
                log.debug("%s " + fmt, self.address_string(), *args)

        return Handler

    def start(self, port: int, host: str = "0.0.0.0") -> int:
        """Bind and serve on a background thread (port 0 = ephemeral);
        returns the bound port."""
        httpd = _WorkHTTPServer((host, port), self._request_handler())
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(target=httpd.serve_forever, name="tpusc-groupwork",
                                        daemon=True)
        self._thread.start()
        return self.port

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.handler.close()


class MultiHostGroupRuntime(TorchModelRuntime):
    """Leader-side runtime of a group that spans processes: every collective
    op goes to the followers FIRST (asynchronously), then runs here, then
    joins the followers' answers. The group lock makes the op stream the
    same in every process."""

    def __init__(self, *args, followers: list[str], group_index: int = 0,
                 work_timeout_s: float = 600.0, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._followers = list(followers)
        self._group_index = group_index
        # each op's bound on a follower: the client-facing deadline
        # (serving.load_timeout_s) when configured, capped by
        # work_timeout_s; a leader that has answered 504 must not leave its
        # followers decoding for minutes with the group lock held
        self._work_timeout_s = work_timeout_s
        load_t = getattr(self.cfg, "load_timeout_s", None)
        self._op_timeout_s = min(work_timeout_s, load_t) if load_t else work_timeout_s
        self._group_lock = threading.RLock()
        self._bcast_pool = ThreadPoolExecutor(max_workers=max(4, 2 * len(self._followers)),
                                              thread_name_prefix="tpusc-bcast")
        # failure containment: a transport-dead follower flips the group
        # unhealthy; requests fail fast (503), the ring heartbeat drops the
        # group (check()), and the re-formation thread probes until every
        # follower answers, then resets the whole group to an empty
        # lockstep state and rejoins
        self._unhealthy_reason: str | None = None
        self._health_lock = threading.Lock()
        self._reform_thread: threading.Thread | None = None
        # bumped on every re-formation: a failure signal from before the
        # teardown (a slow timeout resolving after the group re-formed)
        # must not tear the new group down
        self._epoch = 0
        if self.metrics is not None:
            self.metrics.group_healthy.labels(str(group_index)).set(1)

    def _cfg_fingerprint(self) -> dict:
        """The op-affecting config every follower checks (``_execute``)."""
        return {"prefix_cache": self._prefix_cache is not None}

    # -- broadcast plumbing -------------------------------------------------
    def _post(self, addr: str, body: bytes, timeout_s: float | None = None) -> None:
        req = urllib.request.Request(
            f"http://{addr}{WORK_PATH}", data=body,
            headers={"Content-Type": "application/octet-stream"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s or self._op_timeout_s) as resp:
                out = json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            # the follower's 500 carries the cause in its JSON body; an HTTP
            # status means the process is ALIVE: an application error, not
            # the group's death
            try:
                detail = json.loads(e.read().decode()).get("error", str(e))
            except Exception:  # noqa: BLE001 - any unreadable body
                detail = str(e)
            raise RuntimeError(f"follower {addr}: {detail}") from None
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            # connection refused or reset, or the work timeout: dead or wedged
            raise FollowerUnreachable(f"follower {addr}: {e}") from None
        if not out.get("ok"):
            raise RuntimeError(f"follower {addr}: {out.get('error')}")

    def _broadcast(self, meta: dict, arrays: Mapping[str, np.ndarray] | None = None,
                   collective: bool = False):
        # budget_s lets a follower drop a prefetch that expired while queued
        # behind its group lock; cfg is the fingerprint it validates
        meta = dict(meta, group=self._group_index, budget_s=self._op_timeout_s,
                    cfg=self._cfg_fingerprint())
        body = encode_work(meta, arrays)
        futures = [self._bcast_pool.submit(self._post, addr, body) for addr in self._followers]
        if collective:
            # a transport death during a collective marks the group down the
            # moment its future resolves: the leader's own half may be stuck
            # in the collective and never reach _join. Transport errors only:
            # a live follower's 500 is classified at _run_collective's join
            # (a request every process refuses must not tear the group
            # down). The epoch tag keeps a slow pre-teardown failure from
            # tearing down a group that has re-formed since
            epoch = self._epoch

            def _watch(f) -> None:
                # close() cancels queued futures; .exception() of one raises
                if f.cancelled():
                    return
                if isinstance(f.exception(), FollowerUnreachable):
                    self._mark_unhealthy(
                        f"follower died during a collective: {f.exception()}", epoch=epoch)

            for f in futures:
                f.add_done_callback(_watch)
        return futures

    def _acquire_group_lock(self) -> None:
        """A bounded acquire: a request queued behind a wedged op notices
        that the group went unhealthy and answers 503 instead of waiting
        forever."""
        while not self._group_lock.acquire(timeout=0.5):
            self._require_healthy()

    def _join(self, futures) -> None:
        errs = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 - classified below
                errs.append(e)
        if errs:
            msg = f"group followers failed: {'; '.join(str(e) for e in errs)}"
            if any(isinstance(e, FollowerUnreachable) for e in errs):
                # a dead or wedged follower breaks the group's lockstep:
                # contain it (fail fast, leave the ring) rather than queue
                # every request into the wedge; the triggering request gets
                # the same retriable 503 as its successors
                self._mark_unhealthy(msg)
                raise GroupUnhealthyError(
                    f"cross-host group {self._group_index} lost a follower ({msg}); "
                    "retry against a replica"
                )
            raise RuntimeError(msg)

    # -- failure containment / re-formation ---------------------------------
    def _mark_unhealthy(self, reason: str, epoch: int | None = None) -> None:
        with self._health_lock:
            if epoch is not None and epoch != self._epoch:
                return  # a signal from before a completed re-formation
            if self._unhealthy_reason is not None or self._closing.is_set():
                return
            self._unhealthy_reason = reason
            log.error("cross-host group %d torn down: %s; failing requests fast, leaving the "
                      "ring, probing for re-formation every %.1fs", self._group_index, reason,
                      REFORM_PROBE_PERIOD_S)
            if self.metrics is not None:
                self.metrics.group_reforms.labels(str(self._group_index), "torn_down").inc()
                self.metrics.group_healthy.labels(str(self._group_index)).set(0)
            self._reform_thread = threading.Thread(target=self._reform_loop,
                                                   name="tpusc-reform", daemon=True)
            self._reform_thread.start()

    def _require_healthy(self) -> None:
        reason = self._unhealthy_reason
        if reason is not None:
            raise GroupUnhealthyError(
                f"cross-host group {self._group_index} is re-forming after a follower "
                f"failure ({reason}); retry against a replica"
            )

    def _reform_loop(self) -> None:
        """Probe the followers until all answer, then reset every process's
        group state (nothing resident: parity is re-derived by cold loads,
        as the reference's remapped ring keys) and rejoin the ring."""
        while not self._closing.wait(REFORM_PROBE_PERIOD_S):
            try:
                ping = encode_work({
                    "op": "ping", "group": self._group_index, "lock_timeout_s": 0.5,
                    # a config mismatch blocks re-formation HERE, with the
                    # follower's error in the "still down" log, instead of
                    # churning teardown/re-form on every request
                    "cfg": self._cfg_fingerprint(),
                })
                for addr in self._followers:
                    self._post(addr, ping, timeout_s=PING_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 - keep probing
                log.info("group %d still down (%s)", self._group_index, e)
                continue
            # every follower is alive with a free group lock: re-form. The
            # local half may still hold the group lock, stuck in a
            # collective: bound the acquire and keep the group down rather
            # than reset state under a live op (only a restart clears a
            # truly stuck collective)
            if not self._group_lock.acquire(timeout=PING_TIMEOUT_S):
                log.warning("group %d followers recovered but the leader half is still "
                            "wedged; restart required", self._group_index)
                continue
            try:
                self._join(self._broadcast({"op": "reset"}))
                self.reset_group_state()
            except Exception as e:  # noqa: BLE001 - a failed reset retries
                log.warning("group %d re-formation failed: %s", self._group_index, e)
                continue
            finally:
                self._group_lock.release()
            with self._health_lock:
                self._unhealthy_reason = None
                self._epoch += 1  # invalidates the pre-teardown signals
                # the gauge flips INSIDE the lock: a teardown racing this
                # window must not be overwritten back to healthy afterwards
                if self.metrics is not None:
                    self.metrics.group_reforms.labels(str(self._group_index), "reformed").inc()
                    self.metrics.group_healthy.labels(str(self._group_index)).set(1)
            log.info("cross-host group %d re-formed (empty state) and rejoined the ring",
                     self._group_index)
            return

    def check(self) -> None:
        """Ring and health probe: an unhealthy group FAILS its heartbeat, so
        discovery drops this group's membership and replicas absorb its
        keys (the group-level counterpart of the reference's dead-node
        remap)."""
        self._require_healthy()
        super().check()

    def _run_collective(self, meta, arrays, fn):
        """Fire the broadcast, run the local half of the collective, then
        surface any follower error. The local compute MUST start without
        waiting for the followers' answers: those arrive only after the
        followers finish the same collective.

        Failure model: the host-side fallible work (the artifact fetch) runs
        in the joinable prefetch phase (``ensure_loaded``), so a follower
        failing DURING a collective means the processes' device states
        diverged; there is no recovery in band from a half-entered
        collective (a gloo collective whose peer is gone fails at its
        timeout)."""
        self._require_healthy()  # fail fast, never queue into a dead group
        self._acquire_group_lock()
        try:
            self._require_healthy()  # the group may have died while queued
            # meta may be a callable: decisions that must be made atomically
            # with the op stream (the prefix-cache hit, the draft gate) are
            # taken here, under the group lock, just before the broadcast
            futures = self._broadcast(meta() if callable(meta) else meta, arrays,
                                      collective=True)
            try:
                result = fn()
            except BaseException as leader_err:
                # the leader's half failed too: a symmetric failure (every
                # process refused the same bad request before any device
                # work) is an ordinary request error, not the group's death;
                # transport deaths still mark it through _join/_watch
                try:
                    self._join(futures)
                except GroupUnhealthyError:
                    raise  # a dead follower trumps: retriable 503
                except RuntimeError as fe:
                    # the followers' application errors must not mask the
                    # leader's TYPED exception (RuntimeError_ answers 400; a
                    # builtin RuntimeError would 500 a plain bad request)
                    log.debug("followers failed the same op: %s", fe)
                raise leader_err
            try:
                self._join(futures)
            except RuntimeError as e:
                # the leader completed the op but a LIVE follower failed it:
                # the processes' states have diverged (one ran the op, one did
                # not), so the lockstep guarantee is gone: re-form. (A
                # transport death raised GroupUnhealthyError from _join
                # already: RuntimeError_ is not a builtin RuntimeError.)
                self._mark_unhealthy("follower failed a collective op the leader completed "
                                     "(states diverged)")
                raise GroupUnhealthyError(
                    f"cross-host group {self._group_index} diverged on a collective op ({e}); "
                    "re-forming: retry against a replica"
                ) from e
            return result
        finally:
            self._group_lock.release()

    # -- collective ops -----------------------------------------------------
    def ensure_loaded(self, model) -> str:
        mid = model.identifier
        if self.is_loaded(mid):
            return "hbm"
        self._require_healthy()
        self._acquire_group_lock()
        try:
            # phase 1 (joinable, host side only): every process fetches the
            # artifact to its own disk; any provider or disk failure
            # surfaces HERE, before a single process enters the warm-up
            # collective
            self._join(self._broadcast({"op": "prefetch", "model": mid.name,
                                        "version": mid.version}))
            # phase 2 (collective): load, cut and warm up in lockstep
            return self._run_collective(
                {"op": "ensure", "model": mid.name, "version": mid.version}, None,
                lambda: super(MultiHostGroupRuntime, self).ensure_loaded(model))
        finally:
            self._group_lock.release()

    def predict(self, model_id, inputs, output_filter=None):
        return self._run_collective(
            {"op": "predict", "model": model_id.name, "version": model_id.version,
             "output_filter": output_filter},
            inputs,
            lambda: super(MultiHostGroupRuntime, self).predict(model_id, inputs,
                                                               output_filter),
        )

    def generate(self, model_id, input_ids, prompt_lengths=None, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 draft_model_id=None, spec_tokens: int = 4, prefix_rows=None,
                 spec_admitted=None):
        ids = np.asarray(input_ids, np.int32)
        lengths = (
            np.full((ids.shape[0],), ids.shape[1], np.int32)
            if ids.ndim == 2 and prompt_lengths is None
            else np.asarray(prompt_lengths if prompt_lengths is not None else [], np.int32)
        )
        # the leader decides the prefix-cache hit HERE, under the group lock
        # (meta is a callable, see _run_collective), and ships it in the
        # envelope, so that every process provably runs the same ops; a
        # follower whose cache cannot honour it raises before any device op
        # (a divergence: the containment path tears the group down to reset)
        decision = {"rows": -1, "use_draft": draft_model_id is not None}

        def meta() -> dict:
            # the group's draft-acceptance gate, decided by the leader: a
            # gated request ships NO draft, so every process runs the same
            # plain decode
            if draft_model_id is not None:
                decision["use_draft"] = self._spec_admit(model_id, draft_model_id)
            use = decision["use_draft"]
            # ALWAYS an explicit decision: peeked rows (>= 0, the prefix
            # path) or -1 (the plain path without the cache); a follower
            # never decides for itself. Draft requests take the same
            # decision: the speculative path is prefix-aware
            decision["rows"] = -1
            if (self._prefix_cache is not None and ids.ndim == 2 and ids.shape[0] == 1
                    # malformed prompt_lengths reach generate's own
                    # validation (a clean 400), not an IndexError here
                    and lengths.shape == (1,) and 1 <= int(lengths[0]) <= ids.shape[1]):
                decision["rows"] = self._prefix_cache.peek(model_id, ids[0, :int(lengths[0])])
            return {
                "op": "generate", "model": model_id.name, "version": model_id.version,
                "max_new_tokens": max_new_tokens, "temperature": temperature, "top_k": top_k,
                "seed": seed,
                # followers replay the SAME speculative decode: the draft's
                # forwards are collectives too on a cut group
                "draft_model": draft_model_id.name if (draft_model_id and use) else "",
                "draft_version": draft_model_id.version if (draft_model_id and use) else 0,
                "spec_tokens": spec_tokens,
                "prefix_rows": decision["rows"],
            }

        return self._run_collective(
            meta,
            {"input_ids": ids, "prompt_lengths": lengths},
            lambda: super(MultiHostGroupRuntime, self).generate(
                model_id, ids, prompt_lengths=list(lengths), max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, seed=seed,
                draft_model_id=draft_model_id if decision["use_draft"] else None,
                spec_tokens=spec_tokens, prefix_rows=decision["rows"],
                spec_admitted=True if decision["use_draft"] and draft_model_id else None,
            ),
        )

    def unload(self, model_id) -> None:
        # unload runs no collective, but the followers mirror it so that the
        # group's resident sets stay in lockstep (a divergent eviction would
        # make a later follower load run its warm-up collective alone):
        # the same fire/compute/join and divergence classification as any
        # collective op
        self._run_collective(
            {"op": "unload", "model": model_id.name, "version": model_id.version}, None,
            lambda: super(MultiHostGroupRuntime, self).unload(model_id))

    def close(self) -> None:
        self._closing.set()
        if self.metrics is not None:
            # a closed group no longer serves: the gauge must not keep
            # reading healthy on a metrics endpoint that still answers
            self.metrics.group_healthy.labels(str(self._group_index)).set(0)
        self._bcast_pool.shutdown(wait=False, cancel_futures=True)
        reform = self._reform_thread
        if reform is not None:
            reform.join(timeout=PING_TIMEOUT_S + 1.0)
        super().close()
