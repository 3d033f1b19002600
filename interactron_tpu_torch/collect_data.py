"""Collect AI2-THOR episode trees (counterpart of the root collect_data.py):

    python -m interactron_tpu_torch.collect_data train|test [--img_root DIR]
        [--ann_path FILE] [--num_anchors N]

Needs ai2thor and its simulator binary (collect/thor_collector.py). The
defaults are the paths configs/*.yaml read: data/interactron/{split} for
the JPEGs and data/interactron/annotations/interactron_v1_{split}.json.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("split", choices=["train", "test"])
    ap.add_argument("--img_root", default=None)
    ap.add_argument("--ann_path", default=None)
    ap.add_argument("--num_anchors", type=int, default=None)
    args = ap.parse_args(argv)
    img_root = args.img_root or f"data/interactron/{args.split}"
    ann_path = args.ann_path or f"data/interactron/annotations/interactron_v1_{args.split}.json"

    from interactron_tpu_torch.collect.thor_collector import ThorCollector

    ThorCollector().collect_dataset(args.split, img_root, ann_path, args.num_anchors)


if __name__ == "__main__":
    main()
