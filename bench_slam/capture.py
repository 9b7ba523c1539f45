"""What the benchmark takes from the program while the window runs.

Hooks around functions of the port, installed for the window only and
removed after it: they pass every call through unchanged, and

- keep copies of the inputs and outputs of the sampled calls (drawn from
  the seed before the window), for the comparison with the plain
  reference after the window: a tracking call (`track_camera`, with the
  pose at the start of each of its rebin periods), the first iteration of
  a keyframe mapping run (`mapping_run`, the map's Adam step, the window
  poses' gradients and the poses their Adam step makes), and packed blend
  forwards and backwards (B4, B5);
- in a traced run, keep each packed blend launch's shape and march
  lengths, which the roofline readers turn into operations and bytes."""
from __future__ import annotations

import dataclasses


def _clone(x):
    return x.detach().clone()


class Capture:
    """`plan`: {"track": set of k, "map": set of k, "fwd": set of j,
    "bwd": set of j}: the k-th tracking call, the k-th keyframe mapping
    run, and the j-th packed forward and backward of the window."""

    def __init__(self, plan: dict):
        self.plan = plan
        self.launches = False  # keep the packed launches (set while a trace runs)
        self.track: list = []
        self.map: list = []
        self.fwd: list = []
        self.bwd: list = []
        self.launch_log: list = []
        self.iterations: list = []  # tracking iterations of each tracked frame
        self._n = {"track": 0, "map": 0, "fwd": 0, "bwd": 0}
        self._undo: list = []
        self._periods = None  # the sampled tracking call's period poses
        self._step = None  # the sampled mapping run, until its map step
        self._poses = None  # the sampled mapping run, from its map step to its exposure step

    def _take(self, kind: str) -> bool:
        k = self._n[kind]
        self._n[kind] = k + 1
        return k in self.plan.get(kind, ())

    # -- installation -----------------------------------------------------

    def _patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def install(self) -> None:
        from lvdgs_torch.gaussian import model as gm
        from lvdgs_torch.ops import rasterizer_cuda as rc
        from lvdgs_torch.slam import mapping, system, tracking

        self._patch(system, "track_camera", self._track_hook)
        self._patch(tracking, "prepare_bins_with_caps", self._period_hook)
        self._patch(system, "mapping_run", self._map_hook)
        self._patch(gm.MapOptimizer, "step", self._step_hook)
        self._patch(mapping, "_adam", self._adam_hook)
        self._patch(mapping, "lie", self._lie_hook)
        self._patch(rc, "_packed_forward", self._fwd_hook)
        self._patch(rc, "_packed_backward", self._bwd_hook)

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    # -- hooks ------------------------------------------------------------

    def _track_hook(self, orig):
        def track_camera(params, active, cam, intr, rcfg, tcfg):
            if not self._take("track"):
                res = orig(params, active, cam, intr, rcfg, tcfg)
                self.iterations.append(int(res.iterations))
                return res
            snap = {
                "params": {k: _clone(v) for k, v in params.items()},
                "active": _clone(active),
                "cam": {k: _clone(getattr(cam, k)) for k in
                        ("image", "grad_mask", "static_mask", "R", "T", "exposure_a", "exposure_b")},
                "frame": int(cam.uid),
                "intr": dataclasses.asdict(intr),
                "rcfg": dataclasses.asdict(rcfg),
                "tcfg": dataclasses.asdict(tcfg),
            }
            self._periods = []
            try:
                res = orig(params, active, cam, intr, rcfg, tcfg)
            finally:
                periods, self._periods = self._periods, None
            snap["out"] = {"R": _clone(res.R), "T": _clone(res.T), "exposure_a": _clone(res.exposure_a),
                           "exposure_b": _clone(res.exposure_b), "iterations": int(res.iterations),
                           "period_poses": periods}
            self.iterations.append(int(res.iterations))
            self.track.append(snap)
            return res
        return track_camera

    def _period_hook(self, orig):
        def prepare_bins_with_caps(params, active, R, t, *args, **kw):
            if self._periods is not None:
                self._periods.append((_clone(R), _clone(t)))
            return orig(params, active, R, t, *args, **kw)
        return prepare_bins_with_caps

    def _map_hook(self, orig):
        def mapping_run(gmap, opt_state, kfbuf, window_slots, generator, iteration_count, n_iters,
                        local_it0=0, **kw):
            mcfg = kw["mcfg"]
            first = local_it0 == 0 and not mcfg.initialization
            it1 = int(iteration_count) + 1
            # a first iteration that densifies or resets opacities changes
            # the map between its gradient and its Adam step: counted, but
            # the sample moves on to the next run
            clean = (it1 % mcfg.gaussian_update_every != mcfg.gaussian_update_offset
                     and it1 % mcfg.gaussian_reset != 0)
            take = False
            if first:
                k = self._n["map"]
                self._n["map"] = k + 1
                wanted = self.plan.setdefault("map", set())
                take = k in wanted
                if take and not clean:
                    wanted.add(k + 1)
                    take = False
            if not take:
                return orig(gmap, opt_state, kfbuf, window_slots, generator, iteration_count, n_iters,
                            local_it0, **kw)
            n = kfbuf.count
            snap = {
                "params": {k: _clone(v) for k, v in gmap.params().items()},
                "active": _clone(gmap.active),
                "window_slots": [int(s) for s in window_slots],
                "kf_count": int(n),
                "kf_R": _clone(kfbuf.R), "kf_T": _clone(kfbuf.T), "kf_ab": _clone(kfbuf.exposure_ab),
                "kf_frame": [int(f) for f in kfbuf.frame_idx[:n].tolist()],
                "kf_mono": {s: _clone(kfbuf.mono_depth[s]) for s in range(n)},
                "generator_state": generator.get_state().clone(),
                "iteration_count": int(iteration_count),
                "mcfg": dataclasses.asdict(mcfg),
                "rcfg": dataclasses.asdict(kw["rcfg"]),
                "intr": dataclasses.asdict(kw["intr"]),
                "opt": dataclasses.asdict(kw["opt"]),
            }
            self._step = snap
            try:
                return orig(gmap, opt_state, kfbuf, window_slots, generator, iteration_count, n_iters,
                            local_it0, **kw)
            finally:
                self._step = self._poses = None
                if "step" in snap and "pose" in snap:
                    self.map.append(snap)
        return mapping_run

    def _step_hook(self, orig):
        capture = self

        def step(opt, gmap, grads, state, lr_step):
            snap = capture._step
            if snap is None:
                return orig(opt, gmap, grads, state, lr_step)
            capture._step = None
            before = {
                "grads": {k: _clone(v) for k, v in grads.items()},
                "params": {k: _clone(v) for k, v in gmap.params().items()},
                "active": _clone(gmap.active),
                "m": {k: _clone(v) for k, v in state.m.items()},
                "v": {k: _clone(v) for k, v in state.v.items()},
                "count": int(state.count),
                "lr_step": int(lr_step),
            }
            out = orig(opt, gmap, grads, state, lr_step)
            before["after"] = {k: _clone(v) for k, v in gmap.params().items()}
            snap["step"] = before
            # then, in the same iteration: the window poses' Adam step, the
            # pose updates it makes, and the exposures' Adam step
            capture._poses = snap
            snap["pose"] = {"g": None, "moves": []}
            return out
        return step

    def _adam_hook(self, orig):
        def _adam(m, v, g, it, lr, b1, b2, eps):
            snap = self._poses
            if snap is not None:
                if snap["pose"]["g"] is None:
                    snap["pose"]["g"] = _clone(g)
                else:
                    self._poses = None
            return orig(m, v, g, it, lr, b1, b2, eps)
        return _adam

    def _lie_hook(self, orig):
        capture = self

        class Lie:
            """The mapping module's `lie`, recording the pose updates of the
            sampled iteration: (R, T) before and after, in call order."""

            def __getattr__(self, name):
                return getattr(orig, name)

            def apply_delta(self, R, T, tau):
                out = orig.apply_delta(R, T, tau)
                snap = capture._poses
                if snap is not None and snap["pose"]["g"] is not None and not tau.requires_grad:
                    snap["pose"]["moves"].append((_clone(R), _clone(T), _clone(out[0]), _clone(out[1])))
                return out

        return Lie()

    def _fwd_hook(self, orig):
        def _packed_forward(tp, cg, k0, goff, tids, n_groups, ntx, with_nt, probe_wmax, bf16):
            out = orig(tp, cg, k0, goff, tids, n_groups, ntx, with_nt, probe_wmax, bf16)
            if self.launches:
                self._log("fwd", tp, n_groups, out[3], bf16)
            if self._take("fwd"):
                self.fwd.append({
                    "args": [_clone(x) for x in (tp, cg, k0, goff, tids)], "n_groups": int(n_groups),
                    "ntx": int(ntx), "with_nt": bool(with_nt), "probe_wmax": bool(probe_wmax),
                    "bf16": bool(bf16), "out": [_clone(x) for x in out]})
            return out
        return _packed_forward

    def _bwd_hook(self, orig):
        def _packed_backward(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans, n_groups, ntx,
                             bf16):
            out = orig(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans, n_groups, ntx, bf16)
            if self.launches:
                self._log("bwd", tp, n_groups, march, bf16)
            if self._take("bwd"):
                self.bwd.append({
                    "args": [_clone(x) for x in (tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans)],
                    "n_groups": int(n_groups), "ntx": int(ntx), "bf16": bool(bf16), "out": _clone(out)})
            return out
        return _packed_backward

    def _log(self, kind: str, tp, n_groups: int, march, bf16: bool) -> None:
        NB, _, TG, _ = tp.shape
        # the march tensor is kept (not summed here): a sum would be one
        # more launch in the traced window
        self.launch_log.append({"kind": kind, "NB": int(NB), "G": int(n_groups), "TG": int(TG),
                                "bf16": bool(bf16), "march": march})
