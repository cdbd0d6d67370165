"""Checkpoint save and load in torch's file format.

Counterpart of ``rsis_tpu/train/checkpoint.py`` (``model_dir``,
``save_checkpoint``, ``load_checkpoint``, ``checkpoint_exists``). A model
directory ``<models_root>/<model_name>/`` holds the reference's artifacts:

  encoder.pt   FeatureExtractor state_dict, reference key layout
  decoder.pt   RSISDecoder state_dict, reference key layout
  optim.pt     {"enc_opt", "dec_opt", "step"}: both optimizer states and
               the step count
  args.json    the run's Config (takes precedence on resume)

``rsis_tpu.models.torch_import.load_state_dict_file`` and
``import_reference_checkpoint`` read encoder.pt and decoder.pt as they
stand. Every file is written to a temporary name and renamed into place,
so a run killed while saving leaves the previous checkpoint whole. The
JAX package's msgpack and orbax formats are not read or written.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..config import Config
from .step import TrainState

ENCODER_FILE = "encoder.pt"
DECODER_FILE = "decoder.pt"
OPTIM_FILE = "optim.pt"
ARGS_FILE = "args.json"


def model_dir(cfg: Config, name: Optional[str] = None) -> str:
    return os.path.join(cfg.models_root, name or cfg.model_name)


def _replace_into(path: str, write) -> None:
    tmp = f"{path}.tmp"
    write(tmp)
    os.replace(tmp, path)


def _host(tree):
    """A copy of a state_dict or optimizer state with its tensors on the
    CPU."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(cfg: Config, state: TrainState,
                    name: Optional[str] = None) -> str:
    d = model_dir(cfg, name)
    os.makedirs(d, exist_ok=True)
    files = {ENCODER_FILE: state.encoder.state_dict(),
             DECODER_FILE: state.decoder.state_dict(),
             OPTIM_FILE: {"enc_opt": state.enc_opt, "dec_opt": state.dec_opt,
                          "step": state.step}}
    for fname, obj in files.items():
        host = _host(obj)
        _replace_into(os.path.join(d, fname),
                      lambda tmp, host=host: torch.save(host, tmp))
    _replace_into(os.path.join(d, ARGS_FILE), cfg.save)
    return d


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def _read(cfg: Config, name: Optional[str], fname: str):
    return torch.load(os.path.join(model_dir(cfg, name), fname),
                      map_location="cpu", weights_only=True)


def load_weights(cfg: Config, name: Optional[str] = None):
    """(encoder state_dict, decoder state_dict) of a saved model, on the
    CPU: the weights ``evals/forward.make_forward`` takes."""
    return _read(cfg, name, ENCODER_FILE), _read(cfg, name, DECODER_FILE)


def load_checkpoint(cfg: Config, state: TrainState,
                    name: Optional[str] = None) -> Tuple[TrainState, Config]:
    """Restore (state, saved config): the weights into ``state``'s modules
    (in place, on their device) and its optimizer states and step."""
    d = model_dir(cfg, name)
    device = next(state.decoder.parameters()).device
    enc, dec = load_weights(cfg, name)
    state.encoder.load_state_dict(enc)
    state.decoder.load_state_dict(dec)
    optim = _read(cfg, name, OPTIM_FILE)
    state.enc_opt = _to(optim["enc_opt"], device)
    state.dec_opt = _to(optim["dec_opt"], device)
    state.step = int(optim["step"])
    return state, Config.load(os.path.join(d, ARGS_FILE))


def checkpoint_exists(cfg: Config, name: Optional[str] = None) -> bool:
    d = model_dir(cfg, name)
    return all(os.path.exists(os.path.join(d, f))
               for f in (ENCODER_FILE, DECODER_FILE, OPTIM_FILE))
