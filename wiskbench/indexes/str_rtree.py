"""An STR bulk-loaded R-tree over the objects: the paper's data-driven
competitor (§7), built by the port's ``build_str_rtree`` on the host."""


def build(dataset, data, params, device):
    """``dataset``: the port's ``GeoTextDataset``; ``params``: the
    configuration's ``index`` entry (``leaf_size``, ``fanout``)."""
    from repro_torch.baselines.conventional import build_str_rtree

    return build_str_rtree(dataset, leaf_size=int(params["leaf_size"]), fanout=int(params["fanout"]))
