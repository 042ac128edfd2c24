"""COCO-format records, the support index and the eval loader."""
