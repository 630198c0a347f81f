"""CLIP guidance for GT-free training (port of
sealdnerf_tpu/train/clip_guidance.py's FlaxCLIPGuidance, used with
--clip_text and --rand_pose).

`CLIPGuidance.loss_fn(image)` is 1 - the cosine similarity between CLIP's
image features of a rendered frame and its text features of the prompt,
differentiable in the image: a bilinear resize to 224 x 224, CLIP's mean
and std, the image tower, the normalised dot product.

The model is loaded from files already on the disk only: a local directory,
or the Hugging Face cache of `transformers`, where that package imports, and
with local_files_only=True. Nothing is downloaded. Without the package or
the files the guidance is `available = False` with its `reason`, and the
trainer takes no semantic step (the reference's gated behaviour). A caller
may also pass a model of its own (anything with `get_image_features(
pixel_values=)`) and the prompt's text features.
"""

import os

import torch
import torch.nn.functional as F

CLIP_MODEL = "openai/clip-vit-base-patch16"
CLIP_RES = 224
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_pixels(image):
    """image [H, W, 3] in [0, 1] -> CLIP's pixel_values [1, 3, 224, 224]:
    bilinear with half-pixel centres, antialiased when shrinking (as
    jax.image.resize's "bilinear"), then CLIP's mean and std."""
    img = F.interpolate(image.permute(2, 0, 1)[None], size=(CLIP_RES,) * 2,
                        mode="bilinear", align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=image.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=image.device)[None, :, None, None]
    return (img - mean) / std


def _has_local_files(model_name: str) -> bool:
    """Whether the model's config is on the disk: a local directory, or an
    entry of the Hugging Face cache (a file-system lookup only)."""
    if os.path.isdir(model_name):
        return True
    from huggingface_hub import try_to_load_from_cache
    return isinstance(try_to_load_from_cache(model_name, "config.json"), str)


def load_local_clip(model_name: str, text: str, device=None):
    """(model, text features [1, D]) from local files; raises ImportError
    without transformers, OSError without the files and ValueError for a
    name that is neither a directory nor a model id."""
    if not _has_local_files(model_name):
        raise OSError(f"no local files of {model_name}")
    from transformers import CLIPModel, CLIPTokenizer
    model = CLIPModel.from_pretrained(model_name, local_files_only=True)
    tok = CLIPTokenizer.from_pretrained(model_name, local_files_only=True)
    model = model.to(device).eval().requires_grad_(False)
    with torch.no_grad():
        tokens = tok([text], padding=True, return_tensors="pt").to(device)
        return model, model.get_text_features(**tokens)


class CLIPGuidance:
    def __init__(self, text: str, model_name: str = CLIP_MODEL, device=None,
                 model=None, text_features=None):
        self.text = text
        self.available = False
        self.reason = ""
        if model is None:
            try:
                model, text_features = load_local_clip(model_name, text,
                                                       device)
            except (ImportError, OSError, ValueError) as e:
                self.reason = f"{type(e).__name__}: {e}"
                return
        self._model = model
        tf = text_features.detach().float()
        self._text_features = tf / tf.norm(dim=-1, keepdim=True)
        self.available = True

    def loss_fn(self, image):
        """image [H, W, 3] in [0, 1] -> 0-d 1 - cos(image, text),
        differentiable in the image."""
        feat = self._model.get_image_features(pixel_values=clip_pixels(image))
        feat = feat / feat.norm(dim=-1, keepdim=True)
        return 1.0 - (feat * self._text_features.to(feat.device)).sum()
