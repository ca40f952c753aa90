"""Small sizes of the benchmark's configurations, for runs on the CPU."""

SMALL = {
    "pagerank-g500.auto": {"graph": {"scale": 10, "edgefactor": 16,
                                     "initiator": [0.57, 0.19, 0.19, 0.05],
                                     "permute_labels": True}},
    "nmf-netflix.auto": {"matrix": {"users": 2000, "items": 300, "data_rank": 64,
                                    "noise": 0.01}},
}
SEED = 2**31 + 11
