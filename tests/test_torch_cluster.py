"""K4's cluster-size policy (`kernels/assign.scan_cluster_size`): how the
parity scan spreads a tenant's nodes over a thread-block cluster of Q
CTAs, and how many threads a CTA runs, from the tenant count B, the
node count N and the card's SM count. The policy is plain Python, so it
is held here on the CPU; the kernel at every Q is held against its plain
version on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import pytest

from tpusched_torch.kernels import assign as ka

H100_SMS = 132


@pytest.mark.parametrize("B, N, sms, want", [
    (1, 5120, H100_SMS, (16, 512)),     # the headline: 320 nodes a CTA
    (8, 2048, H100_SMS, (16, 256)),     # the tenant batch (t): 128 CTAs
    (8, 5120, H100_SMS, (16, 512)),
    (9, 5120, H100_SMS, (8, 512)),      # 144 > 132: 640 nodes a CTA
    (33, 5120, H100_SMS, (4, 1024)),    # 132 CTAs exactly
    (34, 5120, H100_SMS, (2, 1024)),
    (66, 512, H100_SMS, (2, 256)),
    (67, 5120, H100_SMS, (1, 1024)),
    (200, 300, H100_SMS, (1, 512)),     # the clusters queue
    (1, 64, H100_SMS, (2, 256)),        # at least 32 nodes a CTA
    (1, 31, H100_SMS, (1, 256)),
    (1, 1, H100_SMS, (1, 256)),
    (1, 5120, 16, (16, 512)),
    (1, 5120, 15, (8, 512)),
])
def test_scan_cluster_size(B, N, sms, want):
    assert ka.scan_cluster_size(B, N, sms) == want


@pytest.mark.parametrize("B, N, sms", [
    (0, 5120, H100_SMS), (1, 0, H100_SMS), (1, 5120, 0), (-2, 10, 10)])
def test_scan_cluster_size_refuses(B, N, sms):
    with pytest.raises(ValueError, match="must be >= 1"):
        ka.scan_cluster_size(B, N, sms)


@pytest.mark.parametrize("Q", [0, 3, 5, 32])
def test_scan_threads_refuses_a_cluster_size(Q):
    with pytest.raises(ValueError, match=f"cluster size {Q}"):
        ka.scan_threads(1000, Q)


@pytest.mark.parametrize("Q, N, want", [
    (1, 256, 256), (1, 257, 512), (1, 512, 512), (1, 513, 512), (1, 1024, 512), (1, 1025, 1024),
    (16, 4096, 256), (16, 4097, 512), (16, 8193, 512), (16, 16385, 1024), (1, 9000, 1024),
    (2, 1025, 512), (4, 2048, 512)])
def test_scan_threads(Q, N, want):
    assert ka.scan_threads(N, Q) == want


@pytest.mark.parametrize("sms", [16, 66, H100_SMS])
def test_scan_cluster_size_is_the_largest_that_fits(sms):
    """Over a sweep of B and N: Q is a cluster size the kernel takes,
    every CTA has an SM and 32 nodes (or Q = 1), the next size up breaks
    one of the two; 256 threads for at most 256 nodes a CTA, 1 024 for
    more than 1 024, else 512."""
    for B in (1, 2, 3, 5, 8, 16, 17, 33, 64, 131, 133):
        for N in (1, 31, 32, 33, 64, 300, 1023, 1500, 2048, 5120, 20000):
            Q, threads = ka.scan_cluster_size(B, N, sms)
            assert Q in ka.SCAN_CLUSTERS
            assert Q == 1 or (B * Q <= sms and Q * 32 <= N)
            if Q < ka.SCAN_CLUSTERS[-1]:
                assert B * 2 * Q > sms or 2 * Q * 32 > N
            span = -(-N // Q)
            assert threads in ka.SCAN_THREADS
            assert (threads == 256) == (span <= 256)
            assert (threads == 1024) == (span > 1024)
