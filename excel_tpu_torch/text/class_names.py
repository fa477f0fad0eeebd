"""Dataset class vocabularies and background-category prompt lists (the
port's copy of excel_tpu/text/class_names.py).

Data tables matching the reference's datasets/clip_text.py:6-62 and
datasets/{voc,coco}.py class_list constants. The "new" names are the curated
prompt aliases the text encoder actually sees; the plain names are used for
metric tables.
"""

VOC_CLASSES = [
    "_background_", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

VOC_PROMPT_CLASSES = [
    "aeroplane", "bicycle", "bird avian", "boat", "bottle",
    "bus", "car", "cat", "chair seat", "cow",
    "diningtable", "dog", "horse", "motorbike",
    "person with clothes,people,human",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor screen",
]

VOC_BACKGROUND = [
    "ground", "land", "grass", "tree", "building", "wall", "sky", "lake",
    "water", "river", "sea", "railway", "railroad", "keyboard", "helmet",
    "cloud", "house", "mountain", "ocean", "road", "rock", "street",
    "valley", "bridge", "sign",
]

COCO_CLASSES = [
    "_background_",
    "person", "bicycle", "car", "motorbike", "aeroplane",
    "bus", "train", "truck", "boat", "traffic light",
    "fire hydrant", "stop sign", "parking meter", "bench", "bird",
    "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut",
    "cake", "chair", "sofa", "pottedplant", "bed",
    "diningtable", "toilet", "tvmonitor", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock",
    "vase", "scissors", "teddy bear", "hair drier", "toothbrush",
]

COCO_PROMPT_CLASSES = [
    "person with clothes,people,human", "bicycle", "car", "motorbike",
    "aeroplane",
    "bus", "train", "truck", "boat", "traffic light",
    "fire hydrant", "stop sign", "parking meter", "bench", "bird avian",
    "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack,bag",
    "umbrella,parasol", "handbag,purse", "necktie", "suitcase", "frisbee",
    "skis", "sknowboard", "sports ball", "kite", "baseball bat",
    "glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "wine glass", "cup", "fork", "knife", "dessertspoon",
    "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut",
    "cake", "chair seat", "sofa", "pottedplant", "bed",
    "diningtable", "toilet", "tvmonitor screen", "laptop", "mouse",
    "remote control", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock",
    "vase", "scissors", "teddy bear", "hairdrier,blowdrier", "toothbrush",
]

COCO_BACKGROUND = [
    "ground", "land", "grass", "tree", "building", "wall", "sky", "lake",
    "water", "river", "sea", "railway", "railroad", "helmet",
    "cloud", "house", "mountain", "ocean", "road", "rock", "street",
    "valley", "bridge",
]


# The default ImageNet prompt-ensemble templates of the reference's
# encode_text_with_prompt_ensemble (clip/clip.py:252-269). ExCEL's live path
# passes ['a clean origami {}.'] instead, but the 85-template default is part
# of the public API surface (used when prompt_templates=None). Constant data,
# ordering significant (golden-tested vs the reference default).
IMAGENET_PROMPT_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
    "there is a {} in the scene.", "there is the {} in the scene.",
    "this is a {} in the scene.", "this is the {} in the scene.",
    "this is one {} in the scene.",
]


def prompt_vocabulary(dataset: str) -> list[str]:
    """Foreground prompt names + background categories, in surgery order.

    Mirrors model/model_excel.py:33: fg classes first, then background
    categories appended as extra "classes" for feature surgery.
    """
    if dataset in ("pascal_voc", "voc"):
        return VOC_PROMPT_CLASSES + VOC_BACKGROUND
    if dataset in ("ms_coco", "coco"):
        return COCO_PROMPT_CLASSES + COCO_BACKGROUND
    raise ValueError(f"unknown dataset {dataset!r}")


def class_list(dataset: str) -> list[str]:
    """Evaluation class names incl. background (datasets/voc.py:18,
    datasets/coco.py:12)."""
    if "voc" in dataset:
        return VOC_CLASSES
    if "coco" in dataset:
        return COCO_CLASSES
    raise ValueError(f"unknown dataset {dataset!r}")
