"""ShapeNetPart's category table (``closerlook3d_tpu/data/shapenetpart.py``).

The 16 categories of the official benchmark in its order, with their part
counts (summing to 50); global part ids are the cumulative offsets of
this order. The part-segmentation head takes its width from
``NUM_PARTS`` when a config names the dataset without ``num_parts``, as
the JAX package's dataset factory fills it in. The reader of the files is
not ported.
"""

# (category name, synset id, number of parts)
CATEGORIES = [
    ("Airplane", "02691156", 4), ("Bag", "02773838", 2),
    ("Cap", "02954340", 2), ("Car", "02958343", 4),
    ("Chair", "03001627", 4), ("Earphone", "03261776", 3),
    ("Guitar", "03467517", 3), ("Knife", "03624134", 2),
    ("Lamp", "03636649", 4), ("Laptop", "03642806", 2),
    ("Motorbike", "03790512", 6), ("Mug", "03797390", 2),
    ("Pistol", "03948459", 3), ("Rocket", "04099429", 3),
    ("Skateboard", "04225987", 3), ("Table", "04379243", 3),
]
NUM_PARTS = [c[2] for c in CATEGORIES]  # sums to 50
