"""Class vocabulary, action space and episode geometry (frozen copy of the
port's utils/constants.py).

The category names (1203 LVIS + 32 THOR-extra classes) and the actions are
read from the reference's copy of the vocabulary, `vocabulary.json` beside
this file.
`THOR_CLASS_IDS` are the vocabulary ids whose names are THOR object types:
the evaluators count a predicted category of that set with no ground truth
in the frame as a false positive.
"""

import json
import os

_VOCAB_PATH = os.path.join(os.path.dirname(__file__), "vocabulary.json")

with open(_VOCAB_PATH) as _f:
    _vocab = json.load(_f)

ACTIONS = _vocab["actions"]
tlvis_classes = _vocab["tlvis_classes"]
thor_classes = _vocab["thor_classes"]

NUM_CLASSES = len(tlvis_classes)  # 1235; background/no-object id == NUM_CLASSES
BACKGROUND_CLASS = NUM_CLASSES

_thor_set = frozenset(thor_classes)
THOR_CLASS_IDS = [i for i, name in enumerate(tlvis_classes) if name in _thor_set]

NUM_FRAMES = 5          # frames per episode (4 actions)
NUM_ACTIONS = len(ACTIONS)  # 4
NUM_QUERIES = 50        # DETR object queries
IMG_SIZE = 300          # TEST_RESOLUTION
MAX_BOXES = 50          # padded ground-truth boxes per frame
