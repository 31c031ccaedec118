"""Image preprocessing for the vision towers (host-side numpy; a copy of
``moc_tpu/zeroshot/transform.py``).

Bicubic resize of the short side (floored long side), a center crop to
``image_size`` with banker's rounding of the origin, scale to [0, 1] and
normalise with the CLIP, MUSK (inception) or ImageNet statistics; the PLIP
variant resizes straight to the square. Output is NHWC float32. Resizing
uses PIL where it imports; without PIL the same nearest-index fallback as
the JAX package runs, so both packages preprocess alike on any host.
"""

from __future__ import annotations

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)

# torchvision ImageNet statistics
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def _resize_short_side_dims(w: int, h: int, size: int) -> tuple[int, int]:
    """torchvision ``Resize(int)`` output dims ``(w', h')``: the short side
    set to ``size``, the long side ``int(size * long / short)``, floored."""
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(size * long / short)
    return (new_short, new_long) if w <= h else (new_long, new_short)


def _center_crop_origin(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision ``CenterCrop`` origin: ``int(round((dim - size) / 2))``,
    Python's banker's rounding, not floor."""
    return int(round((h - size) / 2.0)), int(round((w - size) / 2.0))


def _resize_to_unit(image, image_size: int, *, aspect_preserving: bool,
                    interp: str) -> np.ndarray:
    """PIL image or uint8 array → ``[image_size, image_size, 3]`` float32 in
    [0, 1]: short-side resize + center crop, or a direct square resize."""
    try:
        from PIL import Image

        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        w, h = image.size
        dims = (_resize_short_side_dims(w, h, image_size)
                if aspect_preserving else (image_size, image_size))
        image = image.resize(dims, Image.BICUBIC if interp == "bicubic" else Image.BILINEAR)
        arr = np.asarray(image, dtype=np.float32) / 255.0
    except ImportError:  # PIL-free fallback: nearest resize by indexing
        arr = np.asarray(image, dtype=np.float32) / 255.0
        h, w = arr.shape[:2]
        nw, nh = (_resize_short_side_dims(w, h, image_size)
                  if aspect_preserving else (image_size, image_size))
        yi = np.clip((np.arange(nh) * h / nh).astype(int), 0, h - 1)
        xi = np.clip((np.arange(nw) * w / nw).astype(int), 0, w - 1)
        arr = arr[yi][:, xi]
    if aspect_preserving:
        h, w = arr.shape[:2]
        top, left = _center_crop_origin(h, w, image_size)
        arr = arr[top: top + image_size, left: left + image_size]
    return arr


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def preprocess_image(image, image_size: int = 448) -> np.ndarray:
    """CLIP (CONCH) preprocessing: PIL image or uint8 ``[H, W, 3]`` →
    normalised ``[image_size, image_size, 3]`` f32."""
    arr = _resize_to_unit(image, image_size, aspect_preserving=True, interp="bicubic")
    return _normalize(arr, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)


def preprocess_batch(images, image_size: int = 448) -> np.ndarray:
    """``preprocess_image`` of each image (PIL or uint8 ``[H, W, 3]``),
    stacked: ``[N, H', W', 3]`` f32."""
    return np.stack([preprocess_image(im, image_size) for im in images])


def preprocess_image_musk(image, image_size: int = 384) -> np.ndarray:
    """MUSK preprocessing: bicubic short-side resize, center crop, inception
    statistics (mean = std = 0.5)."""
    arr = _resize_to_unit(image, image_size, aspect_preserving=True, interp="bicubic")
    return _normalize(arr, IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD)


def preprocess_image_imagenet(image, image_size: int = 256) -> np.ndarray:
    """ImageNet statistics for the CLAM ResNet-50 encoder; patches at their
    native size need no resize (``image_size`` equal to the patch size),
    otherwise a bilinear square resize comes first."""
    arr = _resize_to_unit(image, image_size, aspect_preserving=False, interp="bilinear")
    return _normalize(arr, IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)


def preprocess_image_plip(image, image_size: int = 224, normalize: bool = False) -> np.ndarray:
    """PLIP preprocessing: a bilinear square resize to [0, 1]; ``normalize``
    applies the CLIP statistics."""
    arr = _resize_to_unit(image, image_size, aspect_preserving=False, interp="bilinear")
    if normalize:
        arr = _normalize(arr, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
    return arr
