"""The scheduling core's memory currency: one slice unit's HBM budget.

The placement tree, the planner and the shared-mode models price memory in a
per-slice budget that the reference sets to 16 GiB (``DeviceSKU.slice_bytes``
of the default SKU; the other SKUs scale it by their memory per slice). The
copies of those modules in this package keep that currency, so the SKU tree
and every number the scheduler algebra gives stay the reference's. The card's
own memory never enters them: a characterization on the card budgets an
instance from ``torch.cuda.get_device_properties`` (``core/partitioner.py``).
"""

HBM_PER_CHIP = 16 * 1024**3  # the reference's slice unit: 16 GiB
