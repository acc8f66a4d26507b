"""Streaming video inference in PyTorch, x1 and the xN DDIM ensemble.

Port of ``diffusionvid_tpu/engine/streaming.py``: per chunk of
``infer_batch`` frames, the backbone and the shared stages run at t=999 on
random boxes (the extract pass).  At ``sample_step == 1`` the conditioned
stage then attends to the global memory once.  At ``sample_step > 1`` (x4 in
the paper's table) every DDIM step re-runs the whole stack on the current
noisy boxes, renews the slots whose best class score is at most
``score_renewal_thresh`` from fresh noise, and the steps' top detections are
merged by one class-aware NMS.  ``start_video`` fills the 900/150-slot
memories from the global frames once (STOP_UPDATE_AFTER_INIT_TEST).  The
video state (memories and the random generator) is threaded through calls.

Noise is drawn from the state's ``torch.Generator`` in one method,
``noise``, in the JAX package's order, so a test can hand in its draws: per
chunk the extract pass's boxes, then at xN the starting signal and, for
every step but the last, the DDIM noise and the renewal noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.diffusion_det import (
    DiffusionDetArch, boxes_to_signal, ddim_times, make_schedule, predict_noise_from_start,
    signal_to_boxes,
)
from ..ops.memory import FeatureMemory, init_memory, update_erase_memory
from .postprocess import postprocess_ensemble, postprocess_frame, select_topk_detections


class StreamState(NamedTuple):
    mem: FeatureMemory       # 900-slot diverse global memory
    mem_dis: FeatureMemory   # 150-slot distinct memory (RES_STAGE >= 2)
    rng: torch.Generator


class StreamingDetector:
    """The streaming path over a video's chunks; ``sample_step`` 1 or the
    xN ensemble (``cfg.MODEL.DiffusionDet.SAMPLE_STEP``).

    Usage::

        model = DiffusionDetArch.from_config(cfg)            # on the card
        det = StreamingDetector(model, sample_step=4)
        state = det.start_video(seed, global_frames, whwh)   # 24 init frames
        state, dets = det.process_chunk(state, frames, whwh)
    """

    def __init__(self, model: DiffusionDetArch, *, infer_batch: int = 8,
                 sample_step: int = 1, mem_size: int = 900,
                 mem_dis_size: int = 150, num_proposals: int = 300,
                 score_renewal_thresh: float = 0.5, nms_thresh: float = 0.5,
                 use_nms: bool = True, detections_per_img: int = 300,
                 stop_update_after_init: bool = True):
        self.model = model
        self.device = next(model.parameters()).device
        self.infer_batch = infer_batch
        self.sample_step = sample_step
        self.mem_size, self.mem_dis_size = mem_size, mem_dis_size
        self.num_proposals = num_proposals
        self.schedule = make_schedule(device=self.device)
        self.score_renewal_thresh = score_renewal_thresh
        self.nms_thresh, self.use_nms = nms_thresh, use_nms
        self.detections_per_img = detections_per_img
        self.stop_update_after_init = stop_update_after_init

    # ---- state ----
    def init_state(self, rng) -> StreamState:
        """``rng``: an int seed or a ``torch.Generator`` on the model's device."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=self.device).manual_seed(int(rng))
        d = self.model.hidden_dim
        return StreamState(init_memory(self.mem_size, d, device=self.device),
                           init_memory(self.mem_dis_size, d, device=self.device), rng)

    def noise(self, state: StreamState, shape):
        """Standard normal noise for the proposal boxes of one chunk."""
        return torch.randn(shape, generator=state.rng, device=self.device)

    def _as_tensors(self, frames, whwh):
        """Frames move to the device in their own dtype (the data layer's
        uint8: a quarter of float32's bytes) and are cast there."""
        frames = torch.as_tensor(frames, device=self.device).to(torch.float32)
        whwh = torch.as_tensor(whwh, dtype=torch.float32, device=self.device)
        return frames, whwh

    # ---- chunk functions ----
    def _extract_chunk(self, frames, whwh, box_init):
        """Backbone + the shared stages at t=999 on the noise boxes
        (diffusion_det.py:436-460)."""
        f = frames.shape[0]
        feats = self.model.extract_features(frames)
        boxes = signal_to_boxes(box_init, whwh, self.schedule.scale)
        t = torch.full((f,), 999, dtype=torch.long, device=self.device)
        logits, pboxes, pro, k1, k2 = self.model.extract_proposals(feats, boxes, t)
        return feats, logits, pboxes, pro, k1, k2

    def _detect_chunk(self, state: StreamState, frames, whwh):
        """Extract pass, then the conditioned refinement (x1) or the DDIM
        steps (xN), then post-processing (diffusion_det.py:417-646)."""
        f, p = frames.shape[0], self.num_proposals
        box_init = self.noise(state, (f, p, 4))
        feats, logits0, boxes0, pro0, k1, k2 = self._extract_chunk(frames, whwh, box_init)

        mem_mask = torch.arange(self.mem_size, device=self.device) < state.mem.count
        mem_dis = mem_dis_mask = None
        if self.model.res_stage >= 2:
            mem_dis = state.mem_dis.feats
            mem_dis_mask = (torch.arange(self.mem_dis_size, device=self.device)
                            < state.mem_dis.count)
        memory = (state.mem.feats, mem_mask, mem_dis, mem_dis_mask)
        pairs = ddim_times(self.schedule.num_timesteps, self.sample_step)
        if self.sample_step > 1:
            return self._ensemble(state, feats, whwh, memory, pairs), (k1, k2)

        if self.model.num_heads_local == 0:
            logits, pred_boxes = logits0, boxes0
        else:
            t_cond = torch.full((f,), pairs[0][0], dtype=torch.long, device=self.device)
            logits, pred_boxes, _ = self.model.refine(feats, boxes0, pro0, t_cond, *memory)
        image_hw = (float(whwh[1]), float(whwh[0]))   # a host sync: after the model's work
        dets = postprocess_frame(logits, pred_boxes, image_hw, self.detections_per_img,
                                 self.use_nms, self.nms_thresh)
        return dets, (k1, k2)

    def _ensemble(self, state: StreamState, feats, whwh, memory, pairs):
        """The xN DDIM steps (diffusion_det.py:541-627): each step runs the
        whole stack on the current signal's boxes; the slots whose best
        class score clears ``score_renewal_thresh`` continue the DDIM
        chain, the rest restart from fresh noise; the last step's signal is
        its prediction.  Every step's top detections join the ensemble."""
        sched = self.schedule
        f, p = feats[0].shape[0], self.num_proposals
        x = self.noise(state, (f, p, 4))
        steps = []
        for t_now, t_next in pairs:
            t_cond = torch.full((f,), t_now, dtype=torch.long, device=self.device)
            boxes_in = signal_to_boxes(x, whwh, sched.scale)
            logits, pred_boxes, _ = self.model.full_forward_test(feats, boxes_in, t_cond,
                                                                 *memory)
            x_start = boxes_to_signal(pred_boxes, whwh, sched.scale)
            if t_next >= 0:
                eps = predict_noise_from_start(sched, x, t_cond, x_start)
                keep = torch.sigmoid(logits).amax(-1, keepdim=True) > self.score_renewal_thresh
                # sigma and c in float32 from the schedule's buffers, as JAX does
                alpha = sched.alphas_cumprod[t_now]
                alpha_next = sched.alphas_cumprod[t_next]
                sigma = torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
                c = torch.sqrt(1 - alpha_next - sigma ** 2)
                noise = self.noise(state, x.shape)
                x_upd = x_start * torch.sqrt(alpha_next) + c * eps + sigma * noise
                fresh = self.noise(state, x.shape)
                x = torch.where(keep, x_upd, fresh)
            else:
                x = x_start
            steps.append(select_topk_detections(logits, pred_boxes, self.detections_per_img))
        boxes, scores, labels = zip(*steps)
        image_hw = (float(whwh[1]), float(whwh[0]))
        return postprocess_ensemble(boxes, scores, labels, image_hw, self.nms_thresh)

    def _update_memory(self, state: StreamState, chunk, whwh, n_valid: int):
        box_init = self.noise(state, (chunk.shape[0], self.num_proposals, 4))
        *_, k1, k2 = self._extract_chunk(chunk, whwh, box_init)
        return self._fold_topk(state, k1, k2, n_valid)

    def _fold_topk(self, state: StreamState, k1, k2, n_valid: int) -> StreamState:
        """Fold the valid frames' top-k features into both memories.
        Padded frames sit at the tail, so their features are past the
        valid prefix."""
        mem = update_erase_memory(state.mem, k1.reshape(-1, k1.shape[-1]),
                                  n_valid * k1.shape[1])
        mem_dis = update_erase_memory(state.mem_dis, k2.reshape(-1, k2.shape[-1]),
                                      n_valid * k2.shape[1])
        return StreamState(mem, mem_dis, state.rng)

    # ---- public API ----
    @torch.inference_mode()
    def start_video(self, rng, global_frames, whwh) -> StreamState:
        """Reset the state and fill the global memory from the global
        frames (diffusion_det.py:389-401, 479-488).  A short last chunk is
        padded by repeating its last frame."""
        state = self.init_state(rng)
        global_frames, whwh = self._as_tensors(global_frames, whwh)
        for s in range(0, global_frames.shape[0], self.infer_batch):
            chunk = global_frames[s: s + self.infer_batch]
            n_valid = chunk.shape[0]
            pad = self.infer_batch - n_valid
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1, -1, -1)], 0)
            state = self._update_memory(state, chunk, whwh, n_valid)
        return state

    @torch.inference_mode()
    def process_chunk(self, state: StreamState, frames, whwh, n_valid: int = None):
        """Detect on one chunk of ``infer_batch`` consecutive frames.

        frames [F, H, W, 3] in 0..255, uint8 or float (pad a short tail
        chunk and ignore its extra outputs); whwh [4] the image size.  Returns (new state,
        ``BoxArray`` with leading dim F)."""
        frames, whwh = self._as_tensors(frames, whwh)
        dets, (k1, k2) = self._detect_chunk(state, frames, whwh)
        if not self.stop_update_after_init:
            nv = frames.shape[0] if n_valid is None else n_valid
            state = self._fold_topk(state, k1, k2, nv)
        return state, dets
