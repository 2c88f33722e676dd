"""Reads the tools an MPEG-4 Part 2 stream's headers carry (ISO/IEC
14496-2 6.2.3 and 6.2.5: the VOL, the user data and each VOP header), in
plain Python and independent of the port's decoder, so that a fixture that
lacks the tool it is named for fails its tests.

    tools = stream_tools(packets)   # the packets of one stream, in file order
"""

from __future__ import annotations

from typing import Dict, List


class _Bits:
    def __init__(self, data: bytes):
        self.bits = ''.join(f'{b:08b}' for b in data)
        self.pos = 0

    def u(self, n: int) -> int:
        if not n:
            return 0
        if self.pos + n > len(self.bits):
            raise ValueError('a header runs past its data')
        v = int(self.bits[self.pos:self.pos + n], 2)
        self.pos += n
        return v


def _units(data: bytes):
    """(start code value, payload) of each start code in data."""
    at = data.find(b'\x00\x00\x01')
    while 0 <= at < len(data) - 3:
        nxt = data.find(b'\x00\x00\x01', at + 4)
        yield data[at + 3], data[at + 4:nxt if nxt >= 0 else len(data)]
        at = nxt


def _matrix(b: _Bits) -> List[int]:
    """A loaded quantiser matrix in zigzag order, up to its end-of-matrix 0
    (the last value repeats)."""
    out = []
    while len(out) < 64:
        v = b.u(8)
        if not v:
            break
        out.append(v)
    return out + [out[-1]] * (64 - len(out)) if out else out


def parse_vol(payload: bytes) -> Dict:
    """The fields of a video object layer header that name coding tools."""
    b = _Bits(payload)
    vol = {}
    b.u(1)
    vol['vo_type'] = b.u(8)
    ver_id = 1
    if b.u(1):
        ver_id = b.u(4)
        b.u(3)
    vol['ver_id'] = ver_id
    if b.u(4) == 15:
        b.u(16)
    vol['low_delay'] = None
    if b.u(1):
        vol['chroma_format'] = b.u(2)
        vol['low_delay'] = b.u(1)
        if b.u(1):
            b.u(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1)
    vol['shape'] = b.u(2)
    b.u(1)
    res = b.u(16)
    vol['time_resolution'] = res
    b.u(1)
    if b.u(1):
        b.u(max((res - 1).bit_length(), 1))
    b.u(1)
    vol['width'] = b.u(13)
    b.u(1)
    vol['height'] = b.u(13)
    b.u(1)
    vol['interlaced'] = b.u(1)
    vol['obmc_disable'] = b.u(1)
    at = vol['at'] = {'sprite_enable': b.pos}  # where fields start (tests edit them)
    vol['sprite_enable'] = b.u(1 if ver_id == 1 else 2)
    if vol['sprite_enable'] in (1, 2):
        if vol['sprite_enable'] == 1:
            b.u(13 + 1 + 13 + 1 + 13 + 1 + 13 + 1)
        vol['sprite_warping_points'] = b.u(6)
        vol['sprite_warping_accuracy'] = b.u(2)
        vol['sprite_brightness_change'] = b.u(1)
        if vol['sprite_enable'] == 1:
            b.u(1)
    at['not_8_bit'] = b.pos
    vol['not_8_bit'] = b.u(1)
    if vol['not_8_bit']:
        b.u(4 + 4)
    vol['quant_type'] = b.u(1)
    vol['intra_matrix'] = vol['inter_matrix'] = None
    if vol['quant_type']:
        if b.u(1):
            vol['intra_matrix'] = _matrix(b)
        if b.u(1):
            vol['inter_matrix'] = _matrix(b)
    vol['quarter_sample'] = b.u(1) if ver_id != 1 else 0
    at['complexity_estimation_disable'] = b.pos
    vol['complexity_estimation_disable'] = b.u(1)
    vol['resync_marker_disable'] = b.u(1)
    vol['data_partitioned'] = b.u(1)
    if vol['data_partitioned']:
        vol['reversible_vlc'] = b.u(1)
    vol['newpred'] = vol['reduced_resolution'] = 0
    if ver_id != 1:
        vol['newpred'] = b.u(1)
        if vol['newpred']:
            b.u(3)
        vol['reduced_resolution'] = b.u(1)
    vol['scalability'] = b.u(1)
    return vol


def parse_vop(payload: bytes, vol: Dict) -> Dict:
    """The coding type, vop_coded and the interlaced fields of a VOP header."""
    b = _Bits(payload[:32])
    vop = {'type': 'IPBS'[b.u(2)]}
    while b.u(1):
        pass
    b.u(1)
    b.u(max((vol['time_resolution'] - 1).bit_length(), 1))
    b.u(1)
    vop['coded'] = b.u(1)
    if not vop['coded']:
        return vop
    if vop['type'] == 'P' or (vop['type'] == 'S' and vol['sprite_enable'] == 2):
        vop['rounding'] = b.u(1)
    if vol.get('reduced_resolution') and vop['type'] in 'IP':
        vop['reduced'] = b.u(1)
    b.u(3)
    if vol['interlaced']:
        vop['top_field_first'] = b.u(1)
        vop['alternate_scan'] = b.u(1)
    return vop


def stream_tools(packets) -> Dict:
    """What the headers of a stream's packets carry: the VOL's fields, the
    encoder stamps of its user data, the VOP types (not-coded VOPs apart),
    the packets with two VOPs (a packed bitstream), and the interlaced VOPs'
    top_field_first and alternate_vertical_scan flags."""
    vol, stamps = None, []
    types = {k: 0 for k in 'IPBS'}
    out = dict(not_coded=0, packed_packets=0, top_field_first=0, alternate_scan=0)
    for packet in packets:
        vops = 0
        for code, payload in _units(packet):
            if 0x20 <= code <= 0x2f and vol is None:
                vol = parse_vol(payload)
            elif code == 0xb2:
                stamps.append(payload.split(b'\x00')[0].decode('latin1'))
            elif code == 0xb6:
                vops += 1
                vop = parse_vop(payload, vol)
                if not vop['coded']:
                    out['not_coded'] += 1
                    continue
                types[vop['type']] += 1
                out['top_field_first'] += vop.get('top_field_first', 0)
                out['alternate_scan'] += vop.get('alternate_scan', 0)
        out['packed_packets'] += vops > 1
    return dict(vol=vol, user_data=sorted(set(stamps)), vop_types=types, **out)
