"""Class-name lists (copy of ``viddet_tpu/data/names.py:8-45``: VOC, COCO and
ImageNet-VID with its WordNet synset ids)."""

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)

# ImageNet-VID: 30 classes (synset id, human name).
VID_CLASSES_WN = (
    ("n02691156", "airplane"), ("n02419796", "antelope"), ("n02131653", "bear"),
    ("n02834778", "bicycle"), ("n01503061", "bird"), ("n02924116", "bus"),
    ("n02958343", "car"), ("n02402425", "cattle"), ("n02084071", "dog"),
    ("n02121808", "domestic_cat"), ("n02503517", "elephant"),
    ("n02118333", "fox"), ("n02510455", "giant_panda"),
    ("n02342885", "hamster"), ("n02374451", "horse"), ("n02129165", "lion"),
    ("n01674464", "lizard"), ("n02484322", "monkey"), ("n03790512", "motorcycle"),
    ("n02324045", "rabbit"), ("n02509815", "red_panda"), ("n02411705", "sheep"),
    ("n01726692", "snake"), ("n02355227", "squirrel"), ("n02129604", "tiger"),
    ("n04468005", "train"), ("n01662784", "turtle"), ("n04530566", "watercraft"),
    ("n02062744", "whale"), ("n02391049", "zebra"),
)
VID_CLASSES = tuple(name for _, name in VID_CLASSES_WN)
VID_WN_IDS = tuple(wn for wn, _ in VID_CLASSES_WN)
