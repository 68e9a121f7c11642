"""FM-index construction and loading: the builder (prefix doubling with
torch.sort on a device) and the index formats (npz, `.bwt.2bit.64`)."""
