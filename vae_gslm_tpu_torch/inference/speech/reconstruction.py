"""Resynthesis evaluation: f0 MSE, MCD and WER/CER (port of
``vae_gslm_tpu/inference/speech/reconstruction.py``).

Each batch is resynthesised and compared with the re-vocoded ground
truth on the configured ``tasks``: an LVTR encodes the mels (the
posterior mean: temperature 0), decodes them by diffusion with the
utterance embedding where it has one and vocodes them; the token LM's
codec (``type`` "hubert") decodes the tokens with the mel as its speaker
reference.  ``f0mse`` and ``mcd`` come from ``inference/eval_utils.py``
(plain numpy); ``wer`` needs a CTC model that ``transformers`` loads
from the local path ``asr_model`` (nothing is downloaded), and is
skipped with a warning without one, as in JAX.  No port kernel runs on
this path: the encoder, the diffusion decoder and the vocoder are
convolutions.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...core.masked import Masked
from ...hparams.hp import Hparams
from .. import eval_utils
from .likelihood import LikelihoodEstimator

log = logging.getLogger(__name__)


class ReconstructionEvaluator(LikelihoodEstimator):
    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp, device)
        hp.check_arg_in_hparams("tasks")
        self.tasks = list(hp.tasks)
        self.asr = None
        if "wer" in self.tasks and hp.has("asr_model"):
            try:
                from transformers import AutoModelForCTC, AutoProcessor
                self.asr_processor = AutoProcessor.from_pretrained(
                    hp.asr_model, local_files_only=True)
                self.asr = AutoModelForCTC.from_pretrained(
                    hp.asr_model, local_files_only=True).to(self.device)
            except Exception:       # no transformers, or no local model
                self.asr = None
        if "wer" in self.tasks and self.asr is None:
            log.warning("no local ASR model: the wer task is skipped")
        if self.type == "hubert":
            self.vocoder = self.codec.vocoder
        if hp.has("diffusion"):
            dec = (self.codec.model.decoder if self.type == "hubert"
                   else self.model.decoder)
            dec.override_sampling(
                hp.diffusion.get("sampling_timesteps", None),
                hp.diffusion.get("ddim_sampling_eta", None))

    @torch.no_grad()
    def _transcribe(self, wave: np.ndarray, sr: int) -> str:
        inputs = self.asr_processor(wave, sampling_rate=sr,
                                    return_tensors="pt")
        logits = self.asr(inputs.input_values.to(self.device)).logits
        return self.asr_processor.batch_decode(logits.argmax(-1))[0]

    def _rows(self, batch, key: str) -> Masked:
        x = batch[key]
        return Masked(x.value.to(self.device),
                      x.lengths.to(self.device, torch.int32), 1)

    @torch.no_grad()
    def resynthesise(self, batch, generator: torch.Generator):
        """(the re-vocoded ground truth, the resynthesis), ``Masked``
        waves."""
        gold = self.vocoder.decode(self._rows(batch, "mel"))
        if self.type == "hubert":
            f0 = self._rows(batch, "f0") if "f0" in batch else None
            rec = self.codec.decode(self._rows(batch, self.input_key),
                                    generator, spkr=self._rows(batch, "mel"),
                                    f0=f0)
            return gold, rec
        model_input = self.model_input(batch)
        utt = (self.model.encode_utterance(model_input)
               if self.model.utterance_net is not None else None)
        enc = self.model.encode(model_input, generator, temperature=0.0)
        rec = self.vocoder.decode(self.model.decode(enc, generator, u_c=utt))
        return gold, rec

    def test_step(self, batch, generator: torch.Generator,
                  timings: Optional[Dict[str, float]] = None) -> dict:
        """The batch's per-utterance scores by task (and, for ``wer``,
        both transcripts).  With ``timings`` the seconds of the
        resynthesis (``model``, the device synchronised) and of the
        scoring (``score``) are added to it."""
        sr = self.hp.data.sample_rate
        t0 = time.perf_counter()
        gold, rec = self.resynthesise(batch, generator)
        self.synchronize()
        t1 = time.perf_counter()
        g_w, r_w = (x.value.float().cpu().numpy() for x in (gold, rec))
        g_l, r_l = (x.lengths.cpu().numpy() for x in (gold, rec))
        pairs = [(g_w[i, : g_l[i]], r_w[i, : r_l[i]])
                 for i in range(len(g_w))]
        scores: dict = {}
        if "f0mse" in self.tasks:
            vals = [eval_utils.f0_mse(g, r, sr) for g, r in pairs]
            scores["f0mse"] = [v for v in vals if np.isfinite(v)]
        if "mcd" in self.tasks:
            scores["mcd"] = [eval_utils.mcd_wav(g, r) for g, r in pairs]
        if "wer" in self.tasks and self.asr is not None:
            scores["gt_transcripts"] = [self._transcribe(g, sr)
                                        for g, _ in pairs]
            scores["re_transcripts"] = [self._transcribe(r, sr)
                                        for _, r in pairs]
        if timings is not None:
            timings["model"] = timings.get("model", 0.0) + t1 - t0
            timings["score"] = (timings.get("score", 0.0)
                                + time.perf_counter() - t1)
            timings["utterances"] = timings.get("utterances", 0) + len(pairs)
        return scores

    def run(self, seed: int = 0, max_batches: Optional[int] = None,
            timings: Optional[Dict[str, float]] = None) -> dict:
        """The mean of each score task over the test set (at most
        ``max_batches`` batches), drawing from one generator seeded
        ``seed``; with transcripts also ``re_cer``, ``re_wer`` and the
        reference's ``re_asr_error``.  ``timings`` as in ``test_step``,
        with the utterances scored (``utterances``)."""
        generator = torch.Generator(self.device).manual_seed(seed)
        agg: dict = {t: [] for t in self.tasks}
        gt_all, re_all = [], []
        batches = iter(self.test_dataloader())
        try:
            for i, batch in enumerate(batches):
                if max_batches is not None and i >= max_batches:
                    break
                s = self.test_step(batch, generator, timings)
                for t in ("f0mse", "mcd"):
                    if t in s:
                        agg[t] += s[t]
                gt_all += s.get("gt_transcripts", [])
                re_all += s.get("re_transcripts", [])
        finally:
            batches.close()
        out = {t: float(np.mean(v)) for t, v in agg.items()
               if v and t in ("f0mse", "mcd")}
        if gt_all:
            out["re_cer"] = eval_utils.cer(gt_all, re_all)
            out["re_wer"] = eval_utils.wer(gt_all, re_all)
            out["re_asr_error"] = eval_utils.asr_error_rate(gt_all, re_all)
        return out
