"""COCO-compatible evaluation (pycocotools-free): the port's copy of
``tpuseg/eval/``."""
