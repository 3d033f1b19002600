"""Episode geometry used on the predict / next_action path (own copy of the
numbers in interactron_tpu/utils/constants.py; the class vocabulary is not
needed here)."""

NUM_FRAMES = 5          # frames per episode (4 actions)
NUM_ACTIONS = 4
NUM_QUERIES = 50        # DETR object queries
IMG_SIZE = 300          # TEST_RESOLUTION
MAX_BOXES = 50          # padded ground-truth boxes per frame
